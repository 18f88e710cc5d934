"""State blobs cross between the JAX package and the port.

A v2 blob the port writes is read by the reference's ``parse_state`` /
``restore_state`` and the other way round; both resume to identical
greedy tokens. The port's msgpack codec writes ``msgpack.packb(...,
use_bin_type=True)``'s bytes and reads its output.
"""
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.core import state_io as jax_state_io
from repro.core.keys import model_meta as jax_model_meta
from repro.serving.engine import InferenceEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.core import packer, state_io
from repro_torch.core.keys import model_meta
from repro_torch.models.model import Model
from repro_torch.params import from_jax_params
from repro_torch.serving.engine import InferenceEngine

MAX_LEN = 128


@pytest.fixture(scope="module")
def world(tiny_setup):
    cfg, jm, jp = tiny_setup
    m = Model(get_config("gemma3-270m").reduced(), device="cpu")
    m.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jp)))
    meta = model_meta(m.cfg, "float32")
    toks = np.random.default_rng(9).integers(3, cfg.vocab, (1, 48)).astype(
        np.int32)
    return (cfg, JaxEngine(jm, jp, max_len=MAX_LEN),
            InferenceEngine(m, max_len=MAX_LEN), meta, toks)


def _cache_pair(cfg, dtype, seed=0):
    """The same cache contents as a JAX pytree and a port cache."""
    shape = (cfg.n_layers, 1, 64, cfg.n_kv_heads, cfg.dh)
    rng = np.random.default_rng(seed)
    k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jc = {"segments": [{"k": jnp.asarray(k, jdt), "v": jnp.asarray(v, jdt)}]}
    tc = {"segments": [{"k": torch.from_numpy(k).to(dtype),
                        "v": torch.from_numpy(v).to(dtype)}]}
    return jc, tc


def test_model_meta_bytes_match_reference(tiny_setup):
    from repro.configs import get_config as jax_get_config
    for name in ("float32", "bfloat16"):
        assert model_meta(get_config("gemma3-270m"), name) == \
            jax_model_meta(jax_get_config("gemma3-270m"), name)
        assert model_meta(get_config("gemma3-270m").reduced(), name) == \
            jax_model_meta(tiny_setup[0], name)


def test_blob_is_byte_identical_to_reference(tiny_setup):
    """fp32 only: the reference's extract_state cannot write a bf16 cache
    (numpy refuses a buffer view of ml_dtypes bf16; ROADMAP Queue 3), so
    bf16 blobs are checked by the reference's reader below."""
    cfg = tiny_setup[0]
    jc, tc = _cache_pair(cfg, torch.float32)
    meta = model_meta(get_config("gemma3-270m").reduced(), "float32")
    logits = np.random.default_rng(1).normal(size=(1, cfg.vocab)).astype(
        np.float32)
    for n_eff, lg in ((40, logits), (17, None)):
        mine = state_io.extract_state(tc, n_eff, meta, logits=lg,
                                      compress=False)
        ref = jax_state_io.extract_state(jc, n_eff, meta, logits=lg,
                                         compress=False)
        assert mine == ref
        mine_z = state_io.extract_state(tc, n_eff, meta, logits=lg)
        ref_z = jax_state_io.extract_state(jc, n_eff, meta, logits=lg,
                                           codec="zlib")
        assert mine_z == ref_z


def test_port_blob_resumes_in_jax_and_back(world):
    cfg, je, te, meta, toks = world
    n_pre = 30
    # port prefill -> port blob -> JAX restore -> JAX resume
    tpre = te.start({"tokens": toks[:, :n_pre]})
    blob = state_io.extract_state(tpre.cache, n_pre, meta)
    payload = jax_state_io.parse_state(blob, meta)
    jcache, n_eff, lg = jax_state_io.restore_state(payload, je.new_cache())
    assert n_eff == n_pre and lg is None
    jr = je.resume({"tokens": toks[:, n_pre:]}, jcache, n_pre)
    # JAX prefill -> JAX blob -> port restore -> port resume
    jpre = je.start({"tokens": toks[:, :n_pre]})
    jblob = jax_state_io.extract_state(jpre.cache, n_pre, meta,
                                       codec="zlib")
    tcache, n_eff2, _ = state_io.restore_state(
        state_io.parse_state(jblob, meta), te.new_cache())
    assert n_eff2 == n_pre
    tr = te.resume({"tokens": toks[:, n_pre:]}, tcache, n_pre)
    np.testing.assert_allclose(tr.last_logits, jr.last_logits, atol=1e-5,
                               rtol=1e-5)
    assert np.array_equal(je.generate(jr, 8), te.generate(tr, 8))


def test_full_blob_logits_cross_as_fp16(world):
    cfg, je, te, meta, toks = world
    st = te.start({"tokens": toks})
    blob = state_io.extract_state(st.cache, toks.shape[1], meta,
                                  logits=st.last_logits)
    _, n_eff, lg = jax_state_io.restore_state(
        jax_state_io.parse_state(blob, meta), je.new_cache())
    assert n_eff == toks.shape[1]
    np.testing.assert_array_equal(
        lg, st.last_logits.astype(np.float16).astype(np.float32))


def test_bf16_leaves_survive_both_ways(tiny_setup):
    cfg = tiny_setup[0]
    jc, tc = _cache_pair(cfg, torch.bfloat16, seed=3)
    meta = model_meta(get_config("gemma3-270m").reduced(), "bfloat16")
    blob = state_io.extract_state(tc, 50, meta)
    # port -> port
    tmpl = {"segments": [{k: torch.zeros_like(t) for k, t in
                          tc["segments"][0].items()}]}
    back, _, _ = state_io.restore_state(state_io.parse_state(blob, meta),
                                        tmpl)
    for leaf in ("k", "v"):
        got = back["segments"][0][leaf]
        assert got.dtype == torch.bfloat16
        assert torch.equal(got[:, :, :50], tc["segments"][0][leaf][:, :, :50])
        assert torch.count_nonzero(got[:, :, 50:]) == 0
    # port -> JAX: the same bf16 bits
    jtmpl = jax.tree.map(jnp.zeros_like, jc)
    jback, _, _ = jax_state_io.restore_state(
        jax_state_io.parse_state(blob, meta), jtmpl)
    for leaf in ("k", "v"):
        a = np.asarray(jback["segments"][0][leaf])[:, :, :50]
        b = tc["segments"][0][leaf][:, :, :50].view(torch.int16).numpy()
        assert a.dtype.name == "bfloat16"
        assert np.array_equal(a.view(np.int16), b)


def test_meta_hash_mismatch_is_refused(world):
    cfg, je, te, meta, toks = world
    st = te.start({"tokens": toks[:, :20]})
    blob = state_io.extract_state(st.cache, 20, meta)
    other = model_meta(get_config("gemma3-270m").reduced(), "bfloat16")
    with pytest.raises(ValueError, match="different model"):
        state_io.parse_state(blob, other)
    with pytest.raises(ValueError, match="different model"):
        jax_state_io.parse_state(blob, other)


def test_unsupported_containers_raise(world, monkeypatch):
    """A ZST blob where zstandard does not import, and a corrupt PC3
    container, raise ValueError (ChunkError for PC3): the client's miss."""
    cfg, je, te, meta, toks = world
    st = te.start({"tokens": toks[:, :20]})
    zst = state_io.pack_container(state_io.extract_state_chunks(
        st.cache, 20, meta, codec="zstd")) if state_io.zstd else None
    monkeypatch.setattr(state_io, "zstd", None)
    with pytest.raises(ValueError, match="zstd"):
        state_io.parse_state(b"ZST" + b"\0" * 8, meta)
    if zst is not None:
        with pytest.raises(ValueError, match="zstd"):
            state_io.parse_state(zst, meta)
    for bad in (b"PC3" + b"\0" * 8, b"PC3", b"PC3\x91\xc4\x03abc"):
        with pytest.raises(state_io.ChunkError):
            state_io.parse_state(bad, meta)


def test_restore_refuses_a_prefix_longer_than_the_cache(world):
    cfg, je, te, meta, toks = world
    st = te.start({"tokens": toks})
    blob = state_io.extract_state(st.cache, 40, meta)
    small = te.model.init_cache(1, 32)
    with pytest.raises(ValueError, match="longer than engine cache"):
        state_io.restore_state(state_io.parse_state(blob, meta), small)


# ---------------------------------------------------------------------------
# the msgpack subset codec
# ---------------------------------------------------------------------------

PACK_CASES = [
    None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1,
    2 ** 32, 2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
    -2 ** 31, -2 ** 31 - 1, -2 ** 63, 0.0, -1.5, 1e300, "", "a" * 31,
    "b" * 32, "c" * 255, "d" * 256, "é" * 40000, b"", b"x" * 255,
    b"y" * 256, b"z" * 70000, [], list(range(15)), list(range(16)),
    list(range(70000)), {}, {str(i): i for i in range(15)},
    {str(i): i for i in range(16)},
    {"nested": [{"a": None, "b": [1.25, b"\x00\x01"]}], "k": -7},
]


@pytest.mark.parametrize("obj", PACK_CASES, ids=range(len(PACK_CASES)))
def test_packer_matches_msgpack(obj):
    raw = packer.packb(obj)
    assert raw == msgpack.packb(obj, use_bin_type=True)
    assert packer.unpackb(raw) == msgpack.unpackb(raw, raw=False)


def test_packer_on_real_payloads(world):
    cfg, je, te, meta, toks = world
    st = je.start({"tokens": toks})
    ref_blob = jax_state_io.extract_state(st.cache, 48, meta,
                                          logits=st.last_logits,
                                          compress=False)
    body = ref_blob[3:]
    decoded = msgpack.unpackb(body, raw=False)
    assert packer.unpackb(body) == decoded
    assert packer.packb(decoded) == body
    # a memoryview packs as bin, as the reference hands its leaves over
    arr = np.arange(12, dtype=np.float32)
    view = memoryview(arr).cast("B")
    assert packer.packb({"data": view}) == msgpack.packb(
        {"data": view}, use_bin_type=True)


@pytest.mark.parametrize("bad", [b"\xc1", b"\xd9\x05ab", b"\x92\x01",
                                 b"\x01\x02"])
def test_packer_rejects_malformed_input(bad):
    with pytest.raises(ValueError):
        packer.unpackb(bad)
