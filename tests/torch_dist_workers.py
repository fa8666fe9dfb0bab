"""Rank processes of the port's multi-process CPU tests.

Each job runs in ``world`` processes over gloo, started by
:func:`tests.torch_parity.run_ranks`:

    python tests/torch_dist_workers.py <job> <rank> <world> <dir>

``<dir>`` holds the job's ``args.json`` (and any ``inputs.npz``) and the
``FileStore`` the ranks meet on; each rank writes its result to
``<dir>/rank<r>.json``, and may write arrays to ``<dir>/rank<r>.npz``.
The module imports torch and the port only, never JAX.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

JOBS = {}

# The tiny f32 config of tests/test_workloads.py (4 q heads, 2 kv heads).
TINY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=64, max_seq=32)


def job(fn):
    JOBS[fn.__name__] = fn
    return fn


def _init(rank: int, world: int, d: Path) -> None:
    dist.init_process_group("gloo", store=dist.FileStore(str(d / "store"), world),
                            rank=rank, world_size=world)


def _tiny():
    from tputopo_torch.model import ModelConfig

    return ModelConfig(**TINY, compute_dtype=torch.float32)


def _flat(tree: dict, prefix: str = "") -> dict:
    """``{"a.b": array}`` from a nested dict of tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v.detach().cpu().numpy().copy()
    return out


def _nest(flat) -> dict:
    """The nested dict of arrays back from ``{"a.b": array}``."""
    out: dict = {}
    for key in flat:
        *path, leaf = key.split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(flat[key])
    return out


@job
def rendezvous(rank, world, d, args):
    """Join through the TPUTOPO_* env and broadcast from rank 0."""
    from tputopo_torch.distributed import initialize_from_env

    group = initialize_from_env(device="cpu")
    t = torch.tensor([41.0 + rank]) if rank == 0 else torch.zeros(1)
    dist.broadcast(t, src=0)
    return {"got": t.item(), "rank": dist.get_rank(),
            "world": dist.get_world_size(), "backend": dist.get_backend(),
            "process_id": group.process_id}


@job
def collective(rank, world, d, args):
    """The whole-world all-reduce measurement, then the mesh layout and the
    per-axis measurements on {dp: world / 2, tp: 2}."""
    from tputopo_torch.collective import measure_allreduce, measure_axis_allreduce
    from tputopo_torch.sharding import AXES, build_mesh

    _init(rank, world, d)
    res = measure_allreduce(payload_mb=args["payload_mb"], iters=3, warmup=1)
    out = {"result": res.to_dict(), "time_ms": res.time_ms,
           "algbw_gbps": res.algbw_gbps, "busbw_gbps": res.busbw_gbps}
    plan = build_mesh({"dp": world // 2, "tp": 2}, device="cpu")
    out["mesh"] = plan.mesh.mesh.tolist()
    out["groups"] = {a: dist.get_process_group_ranks(plan.group(a)) for a in AXES}
    out["coords"] = {a: plan.rank(a) for a in AXES}
    out["axis"] = {}
    for a in ("dp", "tp"):
        res = measure_axis_allreduce(plan, a, payload_mb=0.25, iters=2, warmup=1)
        out["axis"][a] = {**res.to_dict(), "ratio": res.busbw_gbps / res.algbw_gbps}
    return out


@job
def train_sharded(rank, world, d, args):
    """One sharded step per case from the converted state in inputs.npz,
    the updated params gathered whole; the sharded state's shards against
    the slices of make_train_state; the sharded forward's logits."""
    from tputopo_torch import sharding as sh
    from tputopo_torch import train as tr
    from tputopo_torch.convert import params_from_numpy, sharded_params_from_numpy
    from tputopo_torch.model import forward

    _init(rank, world, d)
    cfg = _tiny()
    inputs = np.load(d / "inputs.npz")
    tokens = torch.from_numpy(inputs["tokens"])
    full = _nest({k[len("p."):]: inputs[k] for k in inputs.files if k.startswith("p.")})
    out, arrays = {}, {}
    for case in args["cases"]:
        name, axes, accum = case["name"], case["axes"], case["accum"]
        plan = sh.build_mesh(axes, device="cpu")
        specs = tr.state_shardings(plan, cfg)
        params = sharded_params_from_numpy(full, plan, cfg)
        roundtrip = sh.gather_tree(params, specs.params, plan)
        state = tr.TrainState(params=params,
                              opt_state=tr.make_optimizer(args["lr"]).init(params),
                              step=torch.zeros((), dtype=torch.int32))
        if case.get("logits"):
            with sh.activate(plan):
                arrays[f"{name}.logits"] = forward(params, tokens, cfg).numpy()
        step = tr.make_sharded_train_step(plan, cfg, lr=args["lr"], accum_steps=accum)
        state, loss = step(state, sh.local_batch(plan, tokens))
        gathered = sh.gather_tree(state.params, specs.params, plan)
        arrays.update({f"{name}.{k}": v for k, v in _flat(gathered).items()})
        out[name] = {"loss": loss.item(), "step": int(state.step),
                     "roundtrip": all(torch.equal(a, b) for a, b in zip(
                         tr._leaves(roundtrip),
                         tr._leaves(params_from_numpy(full, device="cpu")))),
                     "wq_local": list(state.params["layers"]["wq"].shape),
                     "wk_local": list(state.params["layers"]["wk"].shape)}
        # make_sharded_state's shards are the slices of make_train_state's tree
        got = tr.make_sharded_state(plan, cfg, seed=5)
        want = sh.shard_tree(tr.make_train_state(cfg, 5, device="cpu").params,
                             specs.params, plan)
        out[name]["shards_equal"] = all(
            torch.equal(a, b) for a, b in zip(tr._leaves(got.params), tr._leaves(want)))
    if rank == 0:
        np.savez(d / "rank0.npz", **arrays)
    return out


@job
def checkpoint(rank, world, d, args):
    """Save at {dp: 2, tp: 2} after 3 steps, restore onto {dp: 1, tp: 4},
    train step 4."""
    from tputopo_torch import checkpoint as ck
    from tputopo_torch import sharding as sh
    from tputopo_torch import train as tr

    _init(rank, world, d)
    cfg = _tiny()
    ckpt = d / "ckpt"
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 64, (4, 16)))
    plan = sh.build_mesh({"dp": 2, "tp": 2}, device="cpu")
    state = tr.make_sharded_state(plan, cfg, 0)
    step = tr.make_sharded_train_step(plan, cfg)
    for _ in range(3):
        state, _ = step(state, sh.local_batch(plan, tokens))
    empty = ck.latest_step(ckpt)
    saved = ck.save(ckpt, state, plan=plan, config=cfg)
    specs = tr.state_shardings(plan, cfg)
    before = {k: sh.gather_tree(getattr(state.opt_state, k) if k != "params" else
                                state.params, specs.params, plan)
              for k in ("params", "mu", "nu")}

    plan2 = sh.build_mesh({"dp": 1, "tp": 4}, device="cpu")
    target = tr.make_sharded_state(plan2, cfg, seed=9)
    restored = ck.restore(ckpt, target, plan=plan2, config=cfg)
    specs2 = tr.state_shardings(plan2, cfg)
    after = {k: sh.gather_tree(getattr(restored.opt_state, k) if k != "params" else
                               restored.params, specs2.params, plan2)
             for k in ("params", "mu", "nu")}
    equal = {k: all(torch.equal(a, b) for a, b in zip(tr._leaves(before[k]),
                                                      tr._leaves(after[k])))
             for k in before}
    restored_step = (int(restored.step), int(restored.opt_state.count))
    step2 = tr.make_sharded_train_step(plan2, cfg)
    restored, loss = step2(restored, sh.local_batch(plan2, tokens))
    return {"empty": empty, "saved": saved, "latest": ck.latest_step(ckpt),
            "restored_step": restored_step, "equal": equal,
            "wq_local": list(restored.params["layers"]["wq"].shape),
            "wk_local": list(restored.params["layers"]["wk"].shape),
            "step_after": int(restored.step), "loss_after": loss.item()}


def main(argv: list[str]) -> None:
    name, rank, world, d = argv[0], int(argv[1]), int(argv[2]), Path(argv[3])
    torch.set_num_threads(1)
    args = json.loads((d / "args.json").read_text())
    try:
        out = JOBS[name](rank, world, d, args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    (d / f"rank{rank}.json").write_text(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1:])
