"""The port's chunked state-blob pipeline (v3 ``PC3``), held against the
reference on the same caches; mirrors ``tests/test_blob_pipeline.py``.

Format: the single-pass range upload restores as a dedicated v2 blob
does, with int8 leaves too; the containers are the reference's bytes;
the restorer takes a v2 blob, refuses another model's blob, and a
corrupt, garbage or truncated stream raises ``ChunkError``. Client: a
miss upload is one serialization pass on a K/V model and one per range on
an SSM; a streamed partial hit gives the monolithic resume's tokens and
logits on all three families; a v2 blob streams; a bad stream is a miss.

The reference's ring-wrapped (sliding-window) case is not mirrored: the
port raises on ring caches (ROADMAP Queue 1, item 6).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import state_io as jax_state_io
from repro.models import Model as JaxModel
from repro_torch.config import CacheConfig
from repro_torch.configs import get_config
from repro_torch.configs.deepseek_v3_671b import dense_cut
from repro_torch.core import chunkfmt, state_io
from repro_torch.core.client import EdgeClient
from repro_torch.core.keys import model_meta
from repro_torch.core.server import CacheServer
from repro_torch.core.transport import InProcTransport, StreamCancelled
from repro_torch.data import mmlu
from repro_torch.data.tokenizer import WordHashTokenizer
from repro_torch.device import dtype_name
from repro_torch.models.model import Model
from repro_torch.serving.engine import InferenceEngine

MAX_LEN = 512
TOL = 1e-5
FAMILIES = ("gemma3-270m", "mamba2-780m", "deepseek-v3-671b")
CODECS = ["raw", "zlib"] + (["zstd"] if state_io.zstd is not None else [])


def _config(name):
    cfg = get_config(name).reduced()
    return dense_cut(cfg, 2) if name.startswith("deepseek") else cfg


_MODELS = {}


def _model(name):
    if name not in _MODELS:
        _MODELS[name] = Model(_config(name), device="cpu")
    return _MODELS[name]


def _leaves(cache):
    return dict(state_io._flatten(cache))


def _assert_caches_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for path in la:
        assert la[path].dtype == lb[path].dtype, path
        assert torch.equal(la[path], lb[path]), path


def _prefilled(name, n=24, seed=0):
    model = _model(name)
    toks = np.random.default_rng(seed).integers(
        3, model.cfg.vocab, (1, n)).astype(np.int32)
    logits, cache = model.prefill({"tokens": toks}, model.init_cache(1, 32))
    return model, cache, logits.numpy(), toks


# ---------------------------------------------------------------------------
# format
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantize", [False, True], ids=["plain", "int8"])
@pytest.mark.parametrize("name", FAMILIES)
def test_chunked_ranges_restore_identical_to_v2(name, quantize):
    """Every range of one serialization pass restores exactly as a v2
    blob of that range does (int8 leaves dequantized the same way)."""
    model, cache, _, _ = _prefilled(name)
    meta = model_meta(model.cfg, "float32")
    n_effs = [8, 16, 24]
    state_io.STATS["serialize_passes"] = 0
    lists = state_io.extract_state_ranges(cache, n_effs, meta,
                                          quantize=quantize)
    assert state_io.STATS["serialize_passes"] == 1
    for n_eff in n_effs:
        v3 = state_io.pack_container(lists[n_eff])
        v2 = state_io.extract_state(cache, n_eff, meta, quantize=quantize)
        c3, ne3, _ = state_io.restore_state(
            state_io.parse_state(v3, meta), model.init_cache(1, 32))
        c2, ne2, _ = state_io.restore_state(
            state_io.parse_state(v2, meta), model.init_cache(1, 32))
        assert ne3 == ne2 == n_eff
        _assert_caches_equal(c3, c2)
        if not quantize:
            for path, t in _leaves(c3).items():
                src = _leaves(cache)[path]
                if state_io._leaf_name(path) in state_io.SEQ_LEAVES:
                    assert torch.equal(t[:, :, :n_eff], src[:, :, :n_eff])
                    assert torch.count_nonzero(t[:, :, n_eff:]) == 0
                else:
                    assert torch.equal(t, src)


def _numpy_cache(family, seed=0):
    """The same cache contents as a reference pytree and a port cache."""
    rng = np.random.default_rng(seed)
    if family == "attention":
        shapes = {"k": (2, 1, 40, 2, 32), "v": (2, 1, 40, 2, 32)}
    else:
        template = _model("mamba2-780m").init_cache(1, 8)["segments"][0]
        shapes = {k: tuple(t.shape) for k, t in template.items()}
    vals = {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}
    jc = {"segments": [{k: jnp.asarray(v) for k, v in vals.items()}]}
    tc = {"segments": [{k: torch.from_numpy(v) for k, v in vals.items()}]}
    return jc, tc, rng.normal(size=(1, 512)).astype(np.float32)


@pytest.mark.parametrize("quantize", [False, True], ids=["plain", "int8"])
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("family", ["attention", "ssm"])
def test_containers_are_byte_identical_to_the_reference(family, codec,
                                                        quantize):
    """fp32 (the reference cannot write bf16): every range's chunks and
    container, and a v2 blob, are the reference's bytes."""
    jc, tc, logits = _numpy_cache(family)
    kw = dict(compress=codec != "raw", quantize=quantize,
              codec="auto" if codec == "raw" else codec)
    for n_effs, chunk_layers in (([8, 20, 33], 1), ([40], 2)):
        mine = state_io.extract_state_ranges(tc, n_effs, b"meta",
                                             logits=logits,
                                             chunk_layers=chunk_layers, **kw)
        ref = jax_state_io.extract_state_ranges(jc, n_effs, b"meta",
                                                logits=logits,
                                                chunk_layers=chunk_layers,
                                                **kw)
        assert mine == ref
        for n in n_effs:
            assert state_io.pack_container(mine[n]) == \
                jax_state_io.pack_container(ref[n])
    assert state_io.extract_state(tc, 20, b"meta", logits=logits, **kw) == \
        jax_state_io.extract_state(jc, 20, b"meta", logits=logits, **kw)


def test_int8_leaves_dequantize_as_the_reference_does():
    """The port reads the reference's int8 blobs (v2 and v3) to the bits
    the reference restores, in fp32 and into a bf16 template."""
    jc, tc, _ = _numpy_cache("attention", seed=4)
    for blob in (jax_state_io.extract_state(jc, 30, b"m", quantize=True),
                 jax_state_io.pack_container(jax_state_io.extract_state_chunks(
                     jc, 30, b"m", quantize=True))):
        jback, _, _ = jax_state_io.restore_state(
            jax_state_io.parse_state(blob, b"m"),
            {"segments": [{k: jnp.zeros_like(v) for k, v in
                           jc["segments"][0].items()}]})
        back, _, _ = state_io.restore_state(
            state_io.parse_state(blob, b"m"),
            {"segments": [{k: torch.zeros_like(v) for k, v in
                           tc["segments"][0].items()}]})
        for leaf in ("k", "v"):
            np.testing.assert_array_equal(
                back["segments"][0][leaf].numpy(),
                np.asarray(jback["segments"][0][leaf]))
    # into bf16: the fp32 product, then a round-to-nearest-even cast
    q, scale = state_io._quantize(np.asarray(jc["segments"][0]["k"]))
    got = state_io._dequantize(q, scale, "bfloat16")
    want = jax_state_io._dequantize(q, scale, jnp.bfloat16)
    assert np.array_equal(got.view(torch.int16).numpy(), want.view(np.int16))


@pytest.mark.parametrize("quantize", [False, True], ids=["plain", "int8"])
@pytest.mark.parametrize("name", ["gemma3-270m", "mamba2-780m"])
def test_bf16_containers_read_back_in_both_packages(name, quantize):
    """A bf16 cache (an SSM's ssd leaf stays fp32) as a PC3 container:
    the reference reads back the bits the port does (the reference
    cannot write bf16 itself)."""
    model = _model(name)
    cache = Model(model.cfg, dtype=torch.bfloat16, device="cpu",
                  seed=None).init_cache(1, 16)
    rng = np.random.default_rng(7)
    for t in _leaves(cache).values():
        t.copy_(torch.from_numpy(rng.normal(size=tuple(t.shape)).astype(
            np.float32)))
    meta = model_meta(model.cfg, "bfloat16")
    blob = state_io.pack_container(state_io.extract_state_chunks(
        cache, 9, meta, quantize=quantize))
    back, _, _ = state_io.restore_state(
        state_io.parse_state(blob, meta),
        Model(model.cfg, dtype=torch.bfloat16, device="cpu",
              seed=None).init_cache(1, 16))
    jm = JaxModel(jax_get_config(name).reduced(), dtype=jnp.bfloat16)
    jback, _, _ = jax_state_io.restore_state(
        jax_state_io.parse_state(blob, meta), jm.init_cache(1, 16))
    jleaves = dict(state_io._flatten(jback))
    for path, t in _leaves(back).items():
        j = np.asarray(jleaves[path])
        assert str(j.dtype) == dtype_name(t.dtype)
        bits = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        np.testing.assert_array_equal(
            j.view(np.int16) if t.dtype == torch.bfloat16 else j,
            bits.numpy())
        if not quantize:
            assert torch.equal(t[:, :, :9], _leaves(cache)[path][:, :, :9])


def test_v2_blob_feeds_through_chunked_restorer():
    model, cache, logits, _ = _prefilled("gemma3-270m")
    meta = model_meta(model.cfg, "float32")
    v2 = state_io.extract_state(cache, 20, meta, logits=logits)
    r = state_io.ChunkedRestorer(meta)
    assert r.feed(v2) == []
    assert r.complete and r.v2_payload is not None
    got, n_eff, lg = r.result(model.init_cache(1, 32))
    ref, n_ref, lg_ref = state_io.restore_state(
        state_io.parse_state(v2, meta), model.init_cache(1, 32))
    assert n_eff == n_ref == 20
    np.testing.assert_array_equal(lg, lg_ref)
    _assert_caches_equal(got, ref)
    with pytest.raises(state_io.ChunkError, match="trailing"):
        r.feed(v2)


def test_wrong_model_meta_rejected_chunked():
    model, cache, _, _ = _prefilled("gemma3-270m")
    blob = state_io.pack_container(
        state_io.extract_state_chunks(cache, 4, b"model-A"))
    with pytest.raises(ValueError, match="different model"):
        state_io.parse_state(blob, b"model-B")


def _chunks(name="gemma3-270m"):
    model, cache, _, _ = _prefilled(name)
    meta = model_meta(model.cfg, "float32")
    return model, meta, state_io.extract_state_chunks(cache, 16, meta)


def test_corrupt_data_chunk_raises_chunk_error():
    _, meta, chunks = _chunks()
    bad = bytearray(chunks[1])
    bad[len(bad) // 2] ^= 0xFF
    r = state_io.ChunkedRestorer(meta)
    r.feed(chunks[0])
    with pytest.raises(state_io.ChunkError, match="digest"):
        r.feed(bytes(bad))


@pytest.mark.parametrize("garbage", [b"RAW\x01\x02\x03not-msgpack",
                                     b"ZLB" + b"\x00" * 16, b"XYZ",
                                     b"RAW\x93\x01\x02\x03"])
def test_garbage_header_raises_chunk_error(garbage):
    _, meta, _ = _chunks()
    with pytest.raises(state_io.ChunkError):
        state_io.ChunkedRestorer(meta).feed(garbage)


def test_truncated_stream_is_incomplete_not_wrong():
    model, meta, chunks = _chunks()
    r = state_io.ChunkedRestorer(meta)
    for ch in chunks[:-1]:
        r.feed(ch)
    assert not r.complete
    with pytest.raises(state_io.ChunkError, match="incomplete"):
        r.result(model.init_cache(1, 32))
    with pytest.raises(state_io.ChunkError, match="incomplete"):
        state_io.parse_state(state_io.pack_container(chunks[:-1]), meta)
    r2 = state_io.ChunkedRestorer(meta)
    r2.feed(chunks[0])
    with pytest.raises(state_io.ChunkError, match="size"):
        r2.feed(chunks[1][:-3])


def test_groups_complete_in_stream_order_into_template_views():
    """Each layer group completes once all its bands are in, in compute
    order, and its pieces land in views of the template."""
    model, meta, chunks = _chunks("mamba2-780m")
    r = state_io.ChunkedRestorer(meta)
    done = []
    for ch in chunks:
        done += r.feed(ch)
    assert done == [("segments/0", 0, 1), ("segments/0", 1, 2)]
    assert r.raw_chunks() == chunks and r.bytes_fed == sum(map(len, chunks))
    template = model.init_cache(1, 32)
    g = r.group_tree(done[1], template)
    for name, t in g.items():
        assert t.data_ptr() == template["segments"][0][name][1].data_ptr()
        assert torch.count_nonzero(t) > 0
    with pytest.raises(state_io.ChunkError, match="segment"):
        r.group_tree(("segments/7", 0, 1), template)


def test_chunk_container_and_server_stream():
    _, _, chunks = _chunks()
    blob = chunkfmt.pack_container(chunks)
    assert chunkfmt.is_chunked(blob) and chunkfmt.split_container(blob) == \
        chunks
    assert chunkfmt.split_container(b"ZLBxyz") == [b"ZLBxyz"]
    for bad in (b"PC3", b"PC3\x90", b"PC3\x92\x01\x02", blob[:-5]):
        with pytest.raises(ValueError, match="corrupt chunk container"):
            chunkfmt.split_container(bad)
    server = CacheServer(CacheConfig())
    server.put(b"k3", blob)
    server.put(b"k2", b"ZLB" + b"v2 body")
    server.put(b"bad", b"PC3\x92\x01")
    assert server.handle("get_chunks", {"key": b"k3"}) == \
        {"ok": True, "chunks": chunks}
    assert server.handle("get_chunks", {"key": b"k2"})["chunks"] == \
        [b"ZLB" + b"v2 body"]
    bad = server.handle("get_chunks", {"key": b"bad"})
    assert not bad["ok"] and bad["chunks"] == [] and "corrupt" in bad["error"]
    assert server.handle("get_chunks", {"key": b"none"}) == \
        {"ok": False, "chunks": []}
    # the transport delivers chunks one at a time and can be cancelled
    tr = InProcTransport(server)
    got = []
    hdr, dt, nb = tr.request_stream("get_chunks", {"key": b"k3"},
                                    lambda c, s, n: got.append((c, n)))
    assert hdr == {"ok": True, "n_chunks": len(chunks)} and dt >= 0
    assert [c for c, _ in got] == chunks
    assert [n for _, n in got] == [len(c) + 16 for c in chunks]
    assert nb > sum(len(c) + 16 for c in chunks)

    class Stop:
        def is_set(self):
            return len(got) >= len(chunks) + 2

    with pytest.raises(StreamCancelled):
        tr.request_stream("get_chunks", {"key": b"k3"},
                          lambda c, s, n: got.append((c, n)), cancel=Stop())
    assert len(got) == len(chunks) + 2


# ---------------------------------------------------------------------------
# the engine's streamed resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", FAMILIES)
def test_resume_streamed_equals_the_monolithic_resume(name):
    """Layer group by layer group from a PC3 stream: the same logits as
    the monolithic resume from the same blob (fp32, within 1e-5) and as a
    cold prefill, the same cache, and the template is the cache."""
    model = _model(name)
    eng = InferenceEngine(model, max_len=64)
    toks = np.random.default_rng(5).integers(
        3, model.cfg.vocab, (1, 40)).astype(np.int32)
    meta = model_meta(model.cfg, "float32")
    n = 25
    pre = eng.start({"tokens": toks[:, :n]})
    blob = state_io.pack_container(state_io.extract_state_chunks(
        pre.cache, n, meta, logits=pre.last_logits))
    mono_cache, _, _ = state_io.restore_state(
        state_io.parse_state(blob, meta), eng.new_cache())
    mono = eng.resume({"tokens": toks[:, n:]}, mono_cache, n)

    r = state_io.ChunkedRestorer(meta)
    template = eng.new_cache()

    def groups():
        for ch in state_io.split_container(blob):
            for gid in r.feed(ch):
                yield (state_io.segment_index(gid[0]), gid[1], gid[2],
                       r.group_tree(gid, template))

    st = eng.resume_streamed({"tokens": toks[:, n:]}, n, groups(), template)
    assert st.cache is template and st.pos == mono.pos == 40
    np.testing.assert_allclose(st.last_logits, mono.last_logits, atol=TOL,
                               rtol=TOL)
    cold = eng.start({"tokens": toks})
    np.testing.assert_allclose(st.last_logits, cold.last_logits, atol=TOL,
                               rtol=TOL)
    _assert_caches_equal(st.cache, mono.cache)
    assert st.timings["stream_wall"] >= st.timings["prefill_wall"] > 0
    assert np.array_equal(eng.generate(st, 4), eng.generate(mono, 4))


def test_resume_streamed_refuses_bad_group_order():
    model = _model("gemma3-270m")
    eng = InferenceEngine(model, max_len=64)
    toks = np.arange(3, 13, dtype=np.int32)[None]
    template = eng.new_cache()
    seg = template["segments"][0]

    def group(lo, hi):
        return (0, lo, hi, {k: t[lo:hi] for k, t in seg.items()})

    with pytest.raises(ValueError, match="out of order"):
        eng.resume_streamed({"tokens": toks}, 4, [group(1, 2)], template)
    with pytest.raises(ValueError, match="out of order"):
        eng.resume_streamed({"tokens": toks}, 4, [group(0, 1), group(0, 1)],
                            template)
    with pytest.raises(ValueError, match="stream ended"):
        eng.resume_streamed({"tokens": toks}, 4, [group(0, 1)], template)


# ---------------------------------------------------------------------------
# the client
# ---------------------------------------------------------------------------

def _world(name):
    model = _model(name)
    gen = mmlu.MMLUGenerator(WordHashTokenizer(model.cfg.vocab), n_shot=2)
    server = CacheServer(CacheConfig())

    def client(cname, overlap=False, srv=None):
        return EdgeClient(cname, InferenceEngine(model, max_len=MAX_LEN),
                          srv or server, CacheConfig(), overlap=overlap)
    return model, gen, server, client


@pytest.mark.parametrize("name,passes", [("gemma3-270m", 1),
                                         ("mamba2-780m", None),
                                         ("deepseek-v3-671b", 1)])
def test_miss_upload_serialization_passes(name, passes):
    """A K/V or latent cache: one pass for every range. A recurrent state:
    one pass per range, each with its own state and logits."""
    _, gen, server, client = _world(name)
    c = client("up")
    p = gen.prompt("marketing", 0).segments
    keys = p.keys(c.meta)
    assert len(keys) > 1
    state_io.STATS["serialize_passes"] = 0
    r = c.infer(p, max_new_tokens=2)
    assert r.blob_bytes_up > 0
    assert state_io.STATS["serialize_passes"] == (passes or len(keys))
    for k in keys:
        blob = server.get(k.digest)
        assert state_io.is_chunked(blob)
        payload = state_io.parse_state(blob, c.meta)
        has_logits = payload["logits"] is not None
        assert has_logits == (passes is None or k.n_tokens == len(p.token_ids))


def test_uploads_take_codec_quantize_and_chunk_layers_from_the_config():
    model, gen, server, _ = _world("gemma3-270m")
    cc = CacheConfig(compress_codec="zlib", quantize=True, chunk_layers=2)
    c = EdgeClient("q", InferenceEngine(model, max_len=MAX_LEN), server, cc)
    p_a, p_b = (gen.prompt("anatomy", i).segments for i in (0, 1))
    c.infer(p_a, max_new_tokens=2)
    for key in p_a.keys(c.meta):
        chunks = state_io.split_container(server.get(key.digest))
        assert all(ch[:3] == b"ZLB" for ch in chunks)
        mans = state_io.parse_state(server.get(key.digest), c.meta)[
            "_restorer"].header["chunks"]
        assert {(m["lo"], m["hi"]) for m in mans} == {(0, 2)}
        assert all("q_scale_shape" in ent for m in mans
                   for ent in m["pieces"])
    r = EdgeClient("r", InferenceEngine(model, max_len=MAX_LEN), server,
                   cc, overlap=True)
    r.sync_catalog()
    got = r.infer(p_b, max_new_tokens=2, upload_on_miss=False)
    assert got.case == 4 and got.streamed and got.unreadable_blobs == 0


@pytest.mark.parametrize("name", FAMILIES)
def test_streamed_partial_hit_equals_the_monolithic_resume(name,
                                                           monkeypatch):
    """A streamed Case 4 runs the suffix group by group and gives the
    monolithic resume's and a cold run's tokens. An SSM resumes at the
    matched length from its own range state (never re-running a token);
    a K/V or latent blob without logits at ``matched - 1``."""
    model, gen, server, client = _world(name)
    p_a, p_b = (gen.prompt("nutrition", i).segments for i in (0, 1))
    client("seed").infer(p_a, max_new_tokens=2)
    plain, stream = client("plain"), client("stream", overlap=True)
    for c in (plain, stream):
        c.sync_catalog()
    r_plain = plain.infer(p_b, max_new_tokens=5, upload_on_miss=False)
    starts = []
    real = stream.engine.resume_streamed
    monkeypatch.setattr(stream.engine, "resume_streamed",
                        lambda inputs, n, *a: starts.append(n) or
                        real(inputs, n, *a))
    r_stream = stream.infer(p_b, max_new_tokens=5, upload_on_miss=False)
    cold = client("cold", srv=CacheServer(CacheConfig())).infer(
        p_b, max_new_tokens=5, upload_on_miss=False)
    assert r_stream.case == r_plain.case == 4
    assert r_stream.matched_tokens == r_plain.matched_tokens > 0
    assert r_stream.streamed and not r_plain.streamed
    assert r_stream.chunks_down > 2
    assert r_stream.output_tokens == r_plain.output_tokens == \
        cold.output_tokens
    m = r_stream.matched_tokens
    assert starts == [m if model.has_recurrent_state else m - 1]
    t = r_stream.timings
    assert t["stream_s"] >= t["prefill_s"] > 0 and t["restore_s"] > 0
    assert t["fetch_s"] >= 0 and t["hidden_s"] >= 0
    # the full prompt is not streamed: Case 5 adopts
    assert stream.infer(p_a, max_new_tokens=2, upload_on_miss=False).case == 5


def test_v2_blob_served_to_a_streaming_client():
    """A server holding v2 blobs serves a streaming client: a one-chunk
    stream, restored whole, resumed as usual, the same tokens."""
    _, gen, server, client = _world("gemma3-270m")
    seed = client("seed")
    seed.infer(gen.prompt("astronomy", 0).segments, max_new_tokens=2)
    for key, blob in list(server.store.items()):
        cache, n_eff, logits = state_io.restore_state(
            state_io.parse_state(blob, seed.meta), seed.engine.new_cache())
        server.store[key] = state_io.extract_state(cache, n_eff, seed.meta,
                                                   logits=logits)
    p = gen.prompt("astronomy", 1).segments
    plain, stream = client("plain"), client("stream", overlap=True)
    for c in (plain, stream):
        c.sync_catalog()
    r_plain = plain.infer(p, max_new_tokens=4, upload_on_miss=False)
    r_stream = stream.infer(p, max_new_tokens=4, upload_on_miss=False)
    assert r_stream.matched_tokens == r_plain.matched_tokens > 0
    assert r_stream.chunks_down == 1 and not r_stream.streamed
    assert r_stream.output_tokens == r_plain.output_tokens


def _corrupt_last_chunk(blob):
    chunks = state_io.split_container(blob)
    bad = bytearray(chunks[-1])
    bad[len(bad) // 2] ^= 0xFF
    return state_io.pack_container(chunks[:-1] + [bytes(bad)])


@pytest.mark.parametrize("fault", ["corrupt", "truncated", "container",
                                   "zst"])
@pytest.mark.parametrize("overlap", [False, True], ids=["whole", "streamed"])
def test_client_falls_back_on_an_unreadable_blob(fault, overlap,
                                                 monkeypatch):
    """A corrupt chunk, a truncated stream, a corrupt container or a ZST
    blob where zstandard does not import: every attempt is a miss, the
    request prefills locally with the cold run's tokens, never raising
    and never hanging."""
    _, gen, server, client = _world("gemma3-270m")
    p_a, p_b = (gen.prompt("virology", i).segments for i in (0, 1))
    seed = client("seed")
    seed.infer(p_a, max_new_tokens=2)
    cold = client("cold", srv=CacheServer(CacheConfig())).infer(
        p_b, max_new_tokens=4, upload_on_miss=False)
    for key, blob in list(server.store.items()):
        if fault == "corrupt":
            server.store[key] = _corrupt_last_chunk(blob)
        elif fault == "truncated":
            server.store[key] = state_io.pack_container(
                state_io.split_container(blob)[:-1])
        elif fault == "container":
            server.store[key] = blob[:len(blob) // 2]
        elif state_io.zstd is not None:   # the same state, under ZST
            cache, n_eff, logits = state_io.restore_state(
                state_io.parse_state(blob, seed.meta),
                seed.engine.new_cache())
            server.store[key] = state_io.pack_container(
                state_io.extract_state_chunks(cache, n_eff, seed.meta,
                                              logits=logits, codec="zstd"))
        else:
            server.store[key] = b"ZST" + b"\x28\xb5\x2f\xfd" + bytes(16)
    if fault == "zst":
        monkeypatch.setattr(state_io, "zstd", None)
    c = client("c", overlap=overlap)
    c.sync_catalog()
    r = c.infer(p_b, max_new_tokens=4, upload_on_miss=False)
    assert r.case == 1 and r.matched_tokens == 0
    assert r.unreadable_blobs >= 1 and not r.false_positive
    assert r.output_tokens == cold.output_tokens
