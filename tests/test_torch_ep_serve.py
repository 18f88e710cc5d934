"""A MoE model served over a mesh of gloo ranks, against the reference's
``InferenceEngine`` on a meshed ``Model`` of the same shape (fp32 on the
CPU): every rank's greedy tokens identical to the reference's, its
logits within 1e-5 at every step, each rank holding only its slice of
the experts.

The reference runs in a subprocess with 8 host devices on meshes built
with ``axis_types=Auto`` (see ``tests/test_torch_moe_ep.py``), draws the
params and serves a 13-token prompt (a 16-token bucket) and 8 greedy
tokens. The port loads the reference's whole params on every rank
(``init_method="file://..."`` gloo ranks, one launch a mesh) into a
``Model`` built with the mesh, which keeps the rank's slice of each
expert stack as it loads it, and serves the same prompt through its
``InferenceEngine``. A ``Model`` drawn from a seed under the mesh holds
the slices of the same model drawn with no mesh. Cases: reduced
granite-moe-3b-a800m over 2 ranks (1 x 2) and 4 (2 x 2), the resident
path; granite with 6 experts over 2 x 2, which ``moe_forward`` sends to
``moe_ep`` (6 stored experts do not split over 4 ranks; padded to 6 over
the model axis's 2; a batch of 1 replicated over data); and reduced
deepseek-v3-671b (MLA, a shared expert) over 1 x 2.
"""
import json
import os
import tempfile

import numpy as np
import pytest

from repro_torch.configs import get_config
from repro_torch.models import moe
from test_torch_moe_ep import gloo_start, run_reference, wait_all

TOL = 1e-5
N_NEW = 8
PROMPT = 13
MAX_LEN = 64
CASES = [
    dict(name="granite-moe-3b-a800m", mesh=[1, 2], n_experts=0),
    dict(name="granite-moe-3b-a800m", mesh=[2, 2], n_experts=0),
    dict(name="granite-moe-3b-a800m", mesh=[2, 2], n_experts=6),
    dict(name="deepseek-v3-671b", mesh=[1, 2], n_experts=0),
]


def case_id(c) -> str:
    return (f"{c['name']}-{c['mesh'][0]}x{c['mesh'][1]}"
            + (f"-{c['n_experts']}experts" if c["n_experts"] else ""))


REFERENCE = """
    import dataclasses, json, sys
    import jax, numpy as np
    from repro.configs import get_config
    from repro.models import Model
    from repro.serving.engine import InferenceEngine
    cases, out_path = json.loads(sys.argv[1]), sys.argv[2]
    auto = (jax.sharding.AxisType.Auto,) * 2

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from flat(tree[k], f"{prefix}{k}.")
        elif isinstance(tree, (list, tuple)):
            for i, item in enumerate(tree):
                yield from flat(item, f"{prefix}{i}.")
        else:
            yield prefix[:-1], np.asarray(tree)

    def serve(model, params, prompt, n):
        eng = InferenceEngine(model, params, max_len=c["max_len"])
        st = eng.start({"tokens": prompt})
        logits, toks = [st.last_logits], []
        for _ in range(n):
            toks.append(int(np.argmax(st.last_logits[0])))
            logits.append(eng.decode_one(st, np.asarray([[toks[-1]]])))
        return np.asarray(toks), np.stack(logits)

    out = {}
    for c in cases:
        cid = c["id"]
        cfg = get_config(c["name"]).reduced()
        if c["n_experts"]:
            cfg = cfg.replace(moe=dataclasses.replace(
                cfg.moe, n_experts=c["n_experts"]))
        mesh = jax.make_mesh(tuple(c["mesh"]), ("data", "model"),
                             axis_types=auto)
        model = Model(cfg, mesh=mesh)
        params = model.init(jax.random.PRNGKey(0))
        for k, v in flat(params):
            out[f"{cid}/p/{k}"] = v
        prompt = np.random.default_rng(5).integers(
            3, cfg.vocab, (1, c["prompt"])).astype(np.int32)
        out[cid + "/prompt"] = prompt
        out[cid + "/tokens"], out[cid + "/logits"] = serve(
            model, params, prompt, c["n_new"])
    np.savez(out_path, **out)
"""

PORT = """
    import dataclasses, json, sys
    import numpy as np, torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.model import Model
    from repro_torch.models import moe
    from repro_torch.params import expert_slice
    from repro_torch.serving.engine import InferenceEngine
    rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    cases, ref_path, out_path = json.loads(sys.argv[4]), sys.argv[5], sys.argv[6]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=world)
    n_data, n_model = cases[0]["mesh"]
    mesh = make_debug_mesh(n_model, n_data, device_type="cpu")
    ref = np.load(ref_path)
    out = {}
    for c in cases:
        cid = c["id"]
        cfg = get_config(c["name"]).reduced()
        if c["n_experts"]:
            cfg = cfg.replace(moe=dataclasses.replace(
                cfg.moe, n_experts=c["n_experts"]))
        m = Model(cfg, device="cpu", seed=None, mesh=mesh)
        pre = cid + "/p/"
        m.load_state_dict({k[len(pre):]: torch.from_numpy(np.array(ref[k]))
                           for k in ref.files if k.startswith(pre)})
        for k, t in m.state_dict().items():
            if ".moe.w_" in k:
                out[f"{cid}/leaf/{k}"] = np.asarray(t.shape)
        # drawn from a seed: the slices of the model with no mesh
        whole = Model(cfg, device="cpu", seed=3).state_dict()
        E = moe.stored_experts(cfg)
        same = True
        for k, t in Model(cfg, device="cpu", seed=3,
                          mesh=mesh).state_dict().items():
            w = whole[k]
            if ".moe.w_" in k:
                w = expert_slice(w, mesh.get_local_rank("model"), n_model,
                                 E, axis=w.dim() - 3)
            same = same and torch.equal(t, w)
        out[cid + "/seed_slices"] = np.asarray(same)
        try:
            m.loss({"tokens": ref[cid + "/prompt"],
                    "targets": ref[cid + "/prompt"]})
            out[cid + "/train_refused"] = np.asarray(False)
        except NotImplementedError:
            out[cid + "/train_refused"] = np.asarray(True)
        eng = InferenceEngine(m, max_len=c["max_len"])
        st = eng.start({"tokens": ref[cid + "/prompt"]})
        logits, toks = [st.last_logits], []
        for _ in range(c["n_new"]):
            toks.append(int(np.argmax(st.last_logits[0])))
            logits.append(eng.decode_one(st, np.asarray([[toks[-1]]])))
        out[cid + "/tokens"] = np.asarray(toks)
        out[cid + "/logits"] = np.stack(logits)
    np.savez(out_path + f".{rank}.npz", **out)
    print(f"rank {rank}: results written", file=sys.stderr, flush=True)
    dist.barrier()            # no rank tears down while a peer still talks
    dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def served():
    """``(reference, {mesh: [rank npz, ...]})`` for every case."""
    cases = [dict(c, id=case_id(c), prompt=PROMPT, n_new=N_NEW,
                  max_len=MAX_LEN) for c in CASES]
    shapes = sorted({tuple(c["mesh"]) for c in cases})
    groups = {sh: [c for c in cases if tuple(c["mesh"]) == sh]
              for sh in shapes}
    with tempfile.TemporaryDirectory() as tmp:
        refs = {sh: os.path.join(tmp, f"ref{i}.npz")
                for i, sh in enumerate(shapes)}
        procs = [run_reference(REFERENCE, json.dumps(groups[sh]), refs[sh])
                 for sh in shapes]           # a reference process a mesh
        wait_all(procs, "reference")
        ref, port = {}, {}
        for sh in shapes:
            ref.update(np.load(refs[sh]))
            work = tempfile.mkdtemp(dir=tmp)
            out = os.path.join(work, "port")
            n = sh[0] * sh[1]
            wait_all(gloo_start(PORT, n, work, json.dumps(groups[sh]),
                                refs[sh], out), f"port ranks on {sh}")
            port[sh] = [dict(np.load(f"{out}.{r}.npz")) for r in range(n)]
        yield ref, port


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_every_rank_serves_the_references_meshed_tokens(served, case):
    """Greedy tokens identical to the reference's meshed engine, logits
    within 1e-5 at the prefill and at every decode step, on every
    rank."""
    ref, port = served
    cid = case_id(case)
    for r in port[tuple(case["mesh"])]:
        np.testing.assert_array_equal(r[cid + "/tokens"],
                                      ref[cid + "/tokens"])
        np.testing.assert_allclose(r[cid + "/logits"], ref[cid + "/logits"],
                                   atol=TOL, rtol=TOL)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_each_rank_holds_only_its_expert_slice(served, case):
    """Every MoE expert leaf of every rank, loaded from the reference's
    whole stacks, is ``[L, e_pad / n_model, ...]`` (an MTP layer's
    ``[e_pad / n_model, ...]``); the rest of each stack is gone from the
    state dict. Training under the mesh is refused (ROADMAP item
    11a-2)."""
    _, port = served
    cid = case_id(case)
    cfg = get_config(case["name"]).reduced()
    e_stored = case["n_experts"] or moe.stored_experts(cfg)
    e_loc = moe.ep_layout(e_stored, case["mesh"][1])[1]
    for r in port[tuple(case["mesh"])]:
        leaves = {k: v for k, v in r.items() if k.startswith(cid + "/leaf/")}
        assert len(leaves) >= 3 and len(leaves) % 3 == 0  # up, gate, down
        for shape in leaves.values():
            assert shape[len(shape) - 3] == e_loc
        assert bool(r[cid + "/train_refused"])


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_a_seeded_rank_holds_the_slices_of_the_model_with_no_mesh(served,
                                                                  case):
    """Drawn from a seed under the mesh, every rank's state dict is the
    one drawn from the same seed with no mesh, each expert stack cut to
    the rank's slice."""
    _, port = served
    for r in port[tuple(case["mesh"])]:
        assert bool(r[case_id(case) + "/seed_slices"])
