"""Training qwen2-vl-2b on merged image embeddings, in the port against
the reference, on the CPU.

The reference trains a VLM on a batch of the stub vision encoder's
embeddings (``embeds`` [B, S, D], M-RoPE ``positions`` [3, B, S],
``targets``) and masks its training attention by batch row 0's temporal
positions: the key at ``j`` is live for the query at ``i`` when ``0 <=
pos[j] <= pos[i]`` (``repro/models/attention.py::attn_forward``,
``attend``). In Qwen2-VL's layout the patches of an image share one
temporal index, so they see each other both ways. The port carries that
mask to ``flash_prefill`` and its backward as a key limit a query
(``training_key_limit``). Serving prefills mask by index in both packages.

Inputs come from numpy seeds at ``get_config("qwen2-vl-2b").reduced()``
(fp32): B=2, S=24, text at 0-3, a 3 x 3 patch grid at temporal index 4,
then text from 7. Params cross with ``from_jax_params``. Tolerances are
``tests/test_torch_training_grads.py``'s: the loss within 1e-5, each
gradient within 1e-4 of its leaf's largest reference gradient or 1e-7;
attention outputs and their gradients within 1e-5 (the same fp32
arithmetic in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.models.attention import attend
from repro.training import adamw as jax_adamw
from repro.training import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.kernels import flash_prefill as fp
from repro_torch.models import attention as attn_mod
from repro_torch.models.attention import training_key_limit
from repro_torch.models.model import Model
from repro_torch.params import from_jax_params
from repro_torch.training import adamw, make_train_step
from repro_torch.training.data import image_positions, vlm_image_batches

from test_torch_training_grads import (assert_matches, port_loss_and_grads,
                                       reference_loss_and_grads)

NAME = "qwen2-vl-2b"
B, S, TEXT, GRID = 2, 24, 4, 3
TRAIN_OPT = dict(lr=1e-3, warmup_steps=1)     # chip_smoke.py's TRAIN_OPT
ATTN_TOL = 1e-5


def layout(S=S, text=TEXT, grid=GRID):
    """[3, S]: text 0..text-1, the grid's patches at temporal index
    ``text`` (height text + r, width text + c), then text from text +
    grid, the three components equal."""
    t, h, w = (np.arange(S) for _ in range(3))
    n = grid * grid
    t[text:text + n] = text
    h[text:text + n] = text + np.arange(n) // grid
    w[text:text + n] = text + np.arange(n) % grid
    for row in (t, h, w):
        row[text + n:] = text + grid + np.arange(S - text - n)
    return np.stack([t, h, w]).astype(np.int32)


def image_batch(cfg, seed=0, rows=None):
    """Embeddings, positions (every row at ``layout()``, or each row at
    its own ``rows[b]``) and targets, as numpy."""
    rng = np.random.default_rng(seed)
    rows = rows or [layout()] * B
    return {"embeds": (rng.standard_normal((B, S, cfg.d_model))
                       * 0.02).astype(np.float32),
            "positions": np.stack(rows, axis=1),
            "targets": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}


@pytest.fixture(scope="module")
def reference():
    jm = JaxModel(jax_get_config(NAME).reduced())
    return jm, jm.init(jax.random.PRNGKey(0))


def port_model(jp, remat=True):
    m = Model(get_config(NAME).reduced(), device="cpu", seed=None,
              remat=remat)
    m.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jp)),
                      strict=True)
    m.requires_grad_(True)
    return m


# row 1 in another layout: 7 text tokens, a 2 x 2 grid at 7, text from 9
ROWS = {"rows alike": None, "rows differ": [layout(), layout(text=7, grid=2)]}


@pytest.mark.parametrize("rows", list(ROWS))
def test_loss_and_grads_match_the_reference(reference, rows):
    """Loss and every gradient against ``jax.value_and_grad(loss)``; where
    the rows differ, both packages mask every row by row 0's positions
    (M-RoPE still rotates each row by its own)."""
    jm, jp = reference
    b = image_batch(jm.cfg, seed=1, rows=ROWS[rows])
    assert_matches(port_loss_and_grads(port_model(jp), b),
                   reference_loss_and_grads(jm, jp, b))


def test_the_image_mask_moves_the_loss(reference, monkeypatch):
    """The test above can see the mask: the same batch masked by index
    (the key limit dropped) gives another loss."""
    jm, jp = reference
    b = image_batch(jm.cfg, seed=1)
    m = port_model(jp)
    with_limit = port_loss_and_grads(m, b)[0]
    monkeypatch.setattr(Model, "_key_limit", lambda self, batch: None)
    by_index = port_loss_and_grads(m, b)[0]
    assert abs(with_limit - by_index) > 100 * 1e-5, (with_limit, by_index)


def test_three_adamw_steps_match_the_reference(reference):
    """Three train steps at ``chip_smoke.py``'s TRAIN_OPT on three image
    batches: loss, its parts and the grad norm each step within 1e-5."""
    jm, jp = reference
    jopt = jax_adamw(**TRAIN_OPT)
    jstate = jopt.init(jp)
    jstep = jax.jit(jax_make_train_step(jm, jopt))
    m = port_model(jp)
    opt = adamw(**TRAIN_OPT)
    state = opt.init(dict(m.named_parameters()))
    step = make_train_step(m, opt)
    losses = []
    for i in range(3):
        b = image_batch(jm.cfg, seed=10 + i)
        jp, jstate, jmet = jstep(jp, jstate,
                                 {k: jnp.asarray(v) for k, v in b.items()})
        state, pm = step(state, b)
        for k in ("loss", "ce", "grad_norm"):
            assert abs(float(pm[k]) - float(jmet[k])) <= \
                1e-5 * max(1.0, abs(float(jmet[k]))), (i, k)
        losses.append(float(pm["loss"]))
    assert all(np.isfinite(losses))


@pytest.mark.parametrize("H,KV", [(12, 2), (4, 4)])
def test_plain_kernels_with_a_key_limit_match_attend(H, KV):
    """``flash_prefill_plain`` and ``flash_prefill_bwd_plain`` with the key
    limit of an image layout against the reference's ``attend`` with the
    positions as qpos and kpos, and its ``jax.vjp``: GQA 6 (qwen2-vl-2b's
    12 over 2) and GQA 1."""
    rng = np.random.default_rng(H)
    Sq, dh = 40, 32
    pos = layout(S=Sq, text=5, grid=4)[0]
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in (
        (B, Sq, H, dh), (B, Sq, KV, dh), (B, Sq, KV, dh), (B, Sq, H, dh)))
    lim = torch.from_numpy(training_key_limit(pos))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out = fp.flash_prefill_plain(tq, tk, tv, key_limit=lim)
    ref, vjp = jax.vjp(lambda a, b_, c: attend(a, b_, c, jnp.asarray(pos),
                                               jnp.asarray(pos)),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATTN_TOL,
                               rtol=ATTN_TOL)
    got = fp.flash_prefill_bwd_plain(tq, tk, tv, tdo, key_limit=lim)
    for g, r in zip(got, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATTN_TOL,
                                   rtol=ATTN_TOL)
    causal = fp.flash_prefill_plain(tq, tk, tv)
    assert not torch.allclose(out, causal, atol=1e-3)


def test_key_limit_from_positions():
    """Strictly increasing positions (gaps or not) give None, the causal
    rule; repeated ones the count of positions at most each; decreasing
    or negative ones raise. Through the model: such a batch raises, and a
    strictly increasing one passes no limit to the kernel."""
    assert training_key_limit(np.arange(9)) is None
    assert training_key_limit([0, 1, 5, 6, 9]) is None
    np.testing.assert_array_equal(training_key_limit(layout()[0]),
                                  [1, 2, 3, 4] + [13] * 9
                                  + list(range(14, 25)))
    np.testing.assert_array_equal(training_key_limit([0, 0, 0, 3, 3]),
                                  [3, 3, 3, 5, 5])
    assert training_key_limit(layout()[0]).dtype == np.int32
    for bad in ([0, 1, 3, 2], [-1, 0, 1]):
        with pytest.raises(ValueError, match="row 0's temporal positions"):
            training_key_limit(bad)
    cfg = get_config(NAME).reduced()
    m = Model(cfg, device="cpu", seed=3)
    bad = image_batch(cfg)
    bad["positions"][0, 0, 5] = 1
    with pytest.raises(ValueError, match="non-decreasing"):
        m.loss(bad)
    seen = []
    real = attn_mod.flash_prefill
    text = image_batch(cfg)
    text["positions"] = np.broadcast_to(np.arange(S, dtype=np.int32) * 2,
                                        (3, B, S)).copy()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(attn_mod, "flash_prefill", lambda *a, **kw: seen.append(
            kw["key_limit"]) or real(*a, **kw))
        m.loss(text)
        m.loss(image_batch(cfg))
    n = cfg.n_layers
    assert seen[:n] == [None] * n
    assert all(torch.is_tensor(t) and t.dtype == torch.int32
               for t in seen[n:]) and len(seen) == 2 * n


def test_key_limit_is_checked_and_read_once():
    """The wrapper refuses a limit of the wrong kind, one past kv_len or
    decreasing, or with a q_offset or a window; a tensor's host copy is
    taken once and again after an in-place change."""
    q = torch.zeros((1, 6, 2, 32))
    kv = torch.zeros((1, 6, 2, 32))
    lim = torch.tensor([3, 3, 3, 4, 6, 6], dtype=torch.int32)
    assert fp.limit_on_host(lim, q, 6, 0, None) == (3, 3, 3, 4, 6, 6)
    for bad, kw in ((lim.long(), {}), (lim[:5], {}), (lim, {"q_offset": 2}),
                    (lim, {"window": 4}), (lim, {"kv_len": 5}),
                    (torch.tensor([3, 2, 3, 4, 6, 6], dtype=torch.int32),
                     {})):
        with pytest.raises(ValueError, match="key_limit"):
            fp.flash_prefill(q, kv, kv, key_limit=bad, **kw)
    lim[0] = 7
    with pytest.raises(ValueError, match="non-decreasing"):
        fp.flash_prefill(q, kv, kv, key_limit=lim)


def _brute_tiles(Sq, Sk, kv_len, lim):
    """Live (query tile, key tile) pairs of 64 x 64 by element: per key
    tile the query tiles with a live pair, per query tile the key tiles."""
    T = fp.BWD_ROWS
    live = np.arange(Sk)[None, :] < np.minimum(np.asarray(lim)[:, None],
                                               kv_len)
    nq, nk = -(-Sq // T), -(-Sk // T)
    pair = np.array([[live[i * T:(i + 1) * T, j * T:(j + 1) * T].any()
                      for j in range(nk)] for i in range(nq)])
    return pair.sum(0).tolist(), pair.sum(1).tolist()


@pytest.mark.parametrize("seed", range(6))
def test_bwd_tile_counts_under_a_limit_count_the_live_pairs(seed):
    """``bwd_tile_counts`` (the bf16 backward's loop lengths, which
    ``bwd_plan`` sizes from) equals a brute-force count of the live tile
    pairs under random image layouts, ragged lengths and kv_len."""
    rng = np.random.default_rng(seed)
    Sq = int(rng.integers(20, 400))
    grid = int(rng.integers(1, 1 + int(np.sqrt(Sq // 2))))
    text = int(rng.integers(0, Sq - grid * grid + 1))
    lim = training_key_limit(layout(S=Sq, text=text, grid=grid)[0])
    if lim is None:
        lim = np.arange(1, Sq + 1)
    Sk = Sq + int(rng.integers(0, 100))
    kv_len = Sq if seed % 2 else int(lim[-1])
    got = fp.bwd_tile_counts(Sq, Sk, 0, kv_len, None, tuple(lim.tolist()))
    assert [list(c) for c in got] == list(_brute_tiles(Sq, Sk, kv_len, lim))
    assert fp.first_tile(tuple(lim.tolist()), Sq, Sk) == -(-Sq // 64) * 64


def test_serving_prefill_masks_by_index_in_both_packages(reference):
    """The same image batch served: both packages' prefill logits at an
    image row equal those of a prefill cut after that row (a row sees no
    later key: the index mask) and each other, while the training
    forward at that row differs (its patches see the whole image). The
    training / serving difference is the reference's own."""
    jm, jp = reference
    m = port_model(jp)
    b = image_batch(jm.cfg, seed=2)
    e, pos = b["embeds"][:1], b["positions"][:, :1]
    row = TEXT + 2                     # the image's third patch
    inp = {"embeds": e, "positions": pos}
    cut = {"embeds": e[:, :row + 1], "positions": pos[:, :, :row + 1]}
    with torch.no_grad():
        mine = m.prefill(inp, m.init_cache(1, S), last_index=row)[0].numpy()
        mine_cut = m.prefill(cut, m.init_cache(1, S))[0].numpy()
        train = m.forward({**inp, "targets": b["targets"][:1]})[0, row]
    jin = {k: jnp.asarray(v) for k, v in inp.items()}
    ref = np.asarray(jm.prefill(jp, jin, jm.init_cache(1, S),
                                last_index=row)[0])
    ref_cut = np.asarray(jm.prefill(
        jp, {k: jnp.asarray(v) for k, v in cut.items()},
        jm.init_cache(1, S))[0])
    ref_train = np.asarray(jm.forward(jp, jin))[0, row]
    tol = dict(atol=2e-5, rtol=1e-4)   # tests/test_mrope_vlm.py's
    np.testing.assert_allclose(mine, ref, **tol)
    np.testing.assert_allclose(mine, mine_cut, **tol)
    np.testing.assert_allclose(ref, ref_cut, **tol)
    np.testing.assert_allclose(train.numpy(), ref_train, **tol)
    assert not np.allclose(ref[0], ref_train, atol=1e-3)
    assert not np.allclose(mine[0], train.numpy(), atol=1e-3)


def test_vlm_image_batches_follow_the_layout():
    """The batches ``chip_smoke.py`` trains on: every row at the layout
    above, finite stub embeddings, lm_batches' targets."""
    cfg = get_config(NAME).reduced()
    b = next(vlm_image_batches(cfg, B, S, TEXT, GRID, seed=4))
    assert b["embeds"].shape == (B, S, cfg.d_model)
    assert b["positions"].shape == (3, B, S)
    for r in range(B):
        np.testing.assert_array_equal(b["positions"][:, r], layout())
    np.testing.assert_array_equal(image_positions(S, TEXT, GRID), layout())
    assert b["targets"].shape == (B, S) and b["targets"].max() < cfg.vocab
    with pytest.raises(ValueError, match="do not fit"):
        image_positions(10, 4, 3)
