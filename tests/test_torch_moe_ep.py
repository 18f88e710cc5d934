"""The port's expert-parallel MoE (``moe_ep``, ``moe_ep_resident``) on
gloo ranks against the reference's own ``shard_map`` functions on meshes
of the same shapes, fp32 on the CPU, ``out`` and aux within 1e-5.

The reference runs in a subprocess with 8 host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``; the suite's
conftest drops the flag from the main process) on meshes built here with
``axis_types=Auto``: ``jax.make_mesh`` makes Explicit axes by default
under jax 0.9, which the reference's ``shard_map`` bodies were not
written for (``tests/test_sharded.py`` is red for that reason). The port
runs each mesh as that many gloo processes (``init_method="file://..."``,
so no TCP port is raced for), every case of the mesh in one launch with
its own timeout, each rank writing the whole ``out`` it returns (the
data shards gathered back) and its aux to an ``.npz``.

Cases: ``moe_ep`` on (data, model) = (1, 2), (2, 2) and (2, 4), whole and
with ``_TOKEN_CHUNK`` lowered to 8 (the chunked path; 36 tokens on a
rank, so the last chunk is padded), plus a batch of 3 that the data
axis does not divide (replicated over it); ``moe_ep_resident`` on (1,
2), (2, 2) and (1, 4); each at capacity factor 8 (nothing dropped) and
0.5 (rows dropped on every rank), on reduced granite-moe-3b-a800m and on
reduced deepseek-v3-671b's MoE layer (with its shared expert). Also, in
one process: ``moe_forward``'s choice among the three paths over meshes,
token counts and expert counts; the expert slices; the ranks' shares
summed against ``moe_local``.
"""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import moe as jax_moe
from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.params import expert_slice

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
TOL = 1e-5
ARCHS = {"granite": "granite-moe-3b-a800m", "deepseek": "deepseek-v3-671b"}
B, S = 4, 9
LAUNCH_TIMEOUT = 240

EP_MESHES = [(1, 2), (2, 2), (2, 4)]
RESIDENT_MESHES = [(1, 2), (2, 2), (1, 4)]
CASES = (
    [dict(fn="ep", mesh=list(ms), cf=cf, chunk=ch, arch=a, B=B)
     for ms in EP_MESHES for cf in (8.0, 0.5) for ch in (None, 8)
     for a in ARCHS]
    + [dict(fn="ep", mesh=[2, 2], cf=0.5, chunk=8, arch=a, B=3)
       for a in ARCHS]
    + [dict(fn="resident", mesh=list(ms), cf=cf, chunk=None, arch=a, B=B)
       for ms in RESIDENT_MESHES for cf in (8.0, 0.5) for a in ARCHS])


def case_id(c) -> str:
    return (f"{c['fn']}-{c['mesh'][0]}x{c['mesh'][1]}-cf{c['cf']}-"
            f"chunk{c['chunk']}-{c['arch']}-B{c['B']}")


def with_cf(cfg, cf):
    return cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def layer_x(c, d_model):
    return (np.random.default_rng(7).normal(size=(c["B"], S, d_model))
            * 0.1).astype(np.float32)


# ---------------------------------------------------------------------------
# running both sides
# ---------------------------------------------------------------------------

def run_reference(code: str, *args, timeout=LAUNCH_TIMEOUT):
    """``code`` in a subprocess with 8 host devices; returns the Popen."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    return subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(code), *map(str, args)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def gloo_start(code: str, world: int, workdir: str, *args):
    """``code`` as ``world`` gloo ranks (argv: rank, world, store path,
    then ``args``), one process each; returns the Popens."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    store = os.path.join(workdir, "store")
    return [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(code), str(r), str(world),
         store, *map(str, args)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]


def wait_all(procs, what: str, timeout=LAUNCH_TIMEOUT):
    """Wait for every process; kill them all and fail on a timeout, or
    on any non-zero exit with every failed process's output."""
    failed = []
    try:
        for i, p in enumerate(procs):
            out, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                failed.append(f"[{i}] exit {p.returncode}\n{out}\n"
                              f"{err[-4000:]}")
    except subprocess.TimeoutExpired:
        raise AssertionError(f"{what}: no exit in {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        raise AssertionError(f"{what}:\n" + "\n".join(failed))


REFERENCE = """
    import dataclasses, json, sys
    import jax, jax.numpy as jnp, numpy as np
    import repro.models.moe as moe
    from repro.configs import get_config
    cases, inputs, out_path = json.loads(sys.argv[1]), sys.argv[2], sys.argv[3]
    data = np.load(inputs)
    auto = (jax.sharding.AxisType.Auto,) * 2
    out = {}
    for c in cases:
        cid = c["id"]
        cfg = get_config(c["name"]).reduced()
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=c["cf"]))
        p = {k.split("/", 1)[1]: jnp.asarray(data[k]) for k in data.files
             if k.startswith(c["arch"] + "/")}
        moe._TOKEN_CHUNK = c["chunk"] or 8192
        mesh = jax.make_mesh(tuple(c["mesh"]), ("data", "model"),
                             axis_types=auto)
        fn = moe.moe_ep if c["fn"] == "ep" else moe.moe_ep_resident
        y, aux = jax.jit(lambda p, x: fn(p, cfg, x, mesh))(
            p, jnp.asarray(data["x/" + cid]))
        out[cid + "/out"] = np.asarray(y)
        out[cid + "/aux"] = np.asarray(aux)
    np.savez(out_path, **out)
"""

PORT = """
    import dataclasses, json, sys
    import numpy as np, torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import moe
    from repro_torch.params import expert_slice
    rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    cases, inputs, out_path = json.loads(sys.argv[4]), sys.argv[5], sys.argv[6]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=world)
    n_data, n_model = cases[0]["mesh"]
    mesh = make_debug_mesh(n_model, n_data, device_type="cpu")
    m = mesh.get_local_rank("model")
    data = np.load(inputs)
    out = {}
    for c in cases:
        cid = c["id"]
        cfg = get_config(c["name"]).reduced()
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=c["cf"]))
        E = moe.stored_experts(cfg)
        p = {}
        for k in data.files:
            if k.startswith(c["arch"] + "/"):
                name = k.split("/", 1)[1]
                t = torch.from_numpy(data[k])
                p[name] = expert_slice(t, m, n_model, E) \\
                    if name in moe.EXPERT_LEAVES else t
        moe._TOKEN_CHUNK = c["chunk"] or 8192
        fn = moe.moe_ep if c["fn"] == "ep" else moe.moe_ep_resident
        y, aux = fn(p, cfg, torch.from_numpy(data["x/" + cid]), mesh)
        out[cid + "/out"] = y.numpy()
        out[cid + "/aux"] = aux.numpy()
        out[cid + "/experts"] = np.asarray(p["w_up"].shape[0])
    np.savez(out_path + f".{rank}.npz", **out)
    print(f"rank {rank}: results written", file=sys.stderr, flush=True)
    dist.barrier()            # no rank tears down while a peer still talks
    dist.destroy_process_group()
"""


def reference_params(cfg_name, seed=1):
    """The reference's MoE layer params, numpy, by leaf name."""
    cfg = jax_get_config(cfg_name).reduced()
    p = jax_moe.init_moe(jax.random.PRNGKey(seed), cfg, jnp.float32)
    return {k: np.asarray(v) for k, v in p.items()}


@pytest.fixture(scope="module")
def results():
    """Both sides' outputs for every case: ``(reference, {mesh: [rank
    npz, ...]})``. The reference's subprocess and the port's launches
    (one mesh at a time) run side by side."""
    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "inputs.npz")
        arrays = {}
        for a, name in ARCHS.items():
            for k, v in reference_params(name).items():
                arrays[f"{a}/{k}"] = v
        cases = []
        for c in CASES:
            c = dict(c, id=case_id(c), name=ARCHS[c["arch"]])
            d = get_config(c["name"]).reduced().d_model
            arrays["x/" + c["id"]] = layer_x(c, d)
            cases.append(c)
        np.savez(inputs, **arrays)
        ref_out = os.path.join(tmp, "ref.npz")
        ref = run_reference(REFERENCE, json.dumps(cases), inputs, ref_out)
        port = {}
        try:
            for shape in sorted({tuple(c["mesh"]) for c in cases}):
                group = [c for c in cases if tuple(c["mesh"]) == shape]
                work = tempfile.mkdtemp(dir=tmp)
                out = os.path.join(work, "port")
                n = shape[0] * shape[1]
                wait_all(gloo_start(PORT, n, work, json.dumps(group), inputs,
                                    out), f"port ranks on {shape}")
                port[shape] = [dict(np.load(f"{out}.{r}.npz"))
                               for r in range(n)]
        finally:
            wait_all([ref], "reference")
        yield dict(np.load(ref_out)), port


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_each_rank_matches_the_references_sharded_function(results, case):
    """Every rank returns the reference's global ``out`` and aux within
    1e-5, and holds ``e_pad / n_model`` experts."""
    ref, port = results
    cid = case_id(case)
    n_data, n_model = case["mesh"]
    e_stored = moe.stored_experts(get_config(ARCHS[case["arch"]]).reduced())
    ranks = port[tuple(case["mesh"])]
    assert len(ranks) == n_data * n_model
    for r in ranks:
        np.testing.assert_allclose(r[cid + "/out"], ref[cid + "/out"],
                                   atol=TOL, rtol=TOL)
        np.testing.assert_allclose(r[cid + "/aux"], ref[cid + "/aux"],
                                   atol=TOL, rtol=TOL)
        assert int(r[cid + "/experts"]) == \
            moe.ep_layout(e_stored, n_model)[1]


# ---------------------------------------------------------------------------
# in one process
# ---------------------------------------------------------------------------

class StubMesh:
    """A mesh's shape and this rank's coordinates, no process group."""

    def __init__(self, names, shape, coords=None):
        self.mesh_dim_names = tuple(names)
        self.shape = tuple(shape)
        self.coords = coords or {}

    def size(self, i=None):
        return int(np.prod(self.shape)) if i is None else self.shape[i]

    def get_local_rank(self, name):
        return self.coords.get(name, 0)


@pytest.mark.parametrize("names,shape,tokens,n_experts,want", [
    (None, None, 8, 4, "local"),
    (("data",), (4,), 8, 4, "local"),
    (("data", "model"), (2, 2), 8, 4, "resident"),
    (("data", "model"), (1, 4), 4096, 4, "resident"),
    (("data", "model"), (1, 4), 4097, 4, "ep"),
    (("data", "model"), (2, 4), 8, 4, "ep"),          # 4 % 8
    (("data", "model"), (2, 2), 8, 6, "ep"),          # 6 % 4
    (("data", "model"), (2, 4), 8, 20, "resident"),   # stored as 32
    (("model",), (3,), 16, 6, "resident"),
    (("model",), (4,), 16, 6, "ep"),
])
def test_moe_forward_picks_the_references_path(monkeypatch, names, shape,
                                                tokens, n_experts, want):
    """``repro/models/moe.py:313-321``: no model axis -> moe_local; at
    most 4096 tokens and stored experts divisible by model x data ->
    resident; else moe_ep."""
    cfg = get_config("granite-moe-3b-a800m").reduced()
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, n_experts=n_experts))
    picked = []
    for path in ("moe_local", "moe_ep", "moe_ep_resident"):
        monkeypatch.setattr(moe, path, lambda *a, _n=path, **k:
                            picked.append(_n) or (None, None))
    mesh = None if names is None else StubMesh(names, shape)
    moe.moe_forward({}, cfg, torch.zeros(1, tokens, cfg.d_model), mesh)
    assert picked == [{"local": "moe_local", "ep": "moe_ep",
                       "resident": "moe_ep_resident"}[want]]


@pytest.mark.parametrize("e_stored,n_model,n_data", [
    (4, 2, 2), (48, 4, 2), (48, 8, 1), (32, 2, 8), (256, 16, 16)])
def test_resident_experts_lie_in_the_ep_slice(e_stored, n_model, n_data):
    """Resident index ``m * n_data + d`` holds experts inside model index
    m's ``moe_ep`` slice, the ``d``-th part of it."""
    stack = torch.arange(e_stored).view(e_stored, 1, 1)
    e_res = e_stored // (n_model * n_data)
    for m in range(n_model):
        ep = {"w_up": expert_slice(stack, m, n_model, e_stored)}
        for d in range(n_data):
            got = moe.resident_slice(ep, d, n_data)["w_up"].flatten()
            lo = (m * n_data + d) * e_res
            assert got.tolist() == list(range(lo, lo + e_res))


@pytest.mark.parametrize("e_stored,n_model", [(4, 3), (6, 4), (48, 5)])
def test_expert_slices_are_padded_clones(e_stored, n_model):
    """Experts padded with zero experts to ``e_pad``; every slice a new
    tensor (none shares the stack's storage); together the stack."""
    stack = torch.randn(2, e_stored, 3, 5)
    e_pad, e_loc = moe.ep_layout(e_stored, n_model)
    parts = [expert_slice(stack, m, n_model, e_stored, axis=1)
             for m in range(n_model)]
    for p in parts:
        assert p.shape == (2, e_loc, 3, 5)
        assert p.untyped_storage().data_ptr() != \
            stack.untyped_storage().data_ptr()
    whole = torch.cat(parts, dim=1)
    assert torch.equal(whole[:, :e_stored], stack)
    assert torch.count_nonzero(whole[:, e_stored:]) == 0
    assert whole.shape[1] == e_pad


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("path", ["ep", "resident"])
def test_shares_summed_equal_moe_local(arch, path):
    """At capacity factor 8 nothing is dropped: the ranks' shares summed
    (n = 1, 2, 4), plus the shared expert, are the reference's
    ``moe_local`` within 1e-5; the rows the ranks kept (each share's
    group offsets) add up to tokens x top_k."""
    name = ARCHS[arch]
    jcfg = jax_get_config(name).reduced()
    cfg = with_cf(get_config(name).reduced(), 8.0)
    p0 = reference_params(name)
    x = layer_x(dict(B=B), cfg.d_model)
    want, _ = jax_moe.moe_local({k: jnp.asarray(v) for k, v in p0.items()},
                                jcfg, jnp.asarray(x))
    p = {k: torch.from_numpy(v) for k, v in p0.items()}
    E = moe.stored_experts(cfg)
    for n in (1, 2, 4):
        total, kept = 0, 0
        for r in range(n):
            pr = {k: (expert_slice(v, r, n, E) if k in moe.EXPERT_LEAVES
                      else v) for k, v in p.items()}
            part = moe.moe_ep_partial(pr, cfg, torch.from_numpy(x), r, n) \
                if path == "ep" else moe.moe_ep_resident_partial(
                    pr, cfg, torch.from_numpy(x), r, n)
            total = total + part.out
            kept += sum(int(o[-1]) for o in part.offsets)
        assert kept == B * S * cfg.moe.top_k
        got = moe._with_shared(total, p, cfg, torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL)
