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


@job
def lora_sharded(rank, world, d, args):
    """Two LoRA steps per case from the converted base and adapter in
    inputs.npz; the adapter and both moments gathered whole, the base
    shards checked unchanged, the losses."""
    from tputopo_torch import lora as tl
    from tputopo_torch import sharding as sh
    from tputopo_torch import train as tr
    from tputopo_torch.convert import lora_from_numpy, sharded_params_from_numpy

    _init(rank, world, d)
    cfg = _tiny()
    inputs = np.load(d / "inputs.npz")
    tokens = torch.from_numpy(inputs["tokens"])
    base_np = _nest({k[2:]: inputs[k] for k in inputs.files if k.startswith("p.")})
    adapter_np = _nest({k[2:]: inputs[k] for k in inputs.files if k.startswith("a.")})
    out, arrays = {}, {}
    for case in args["cases"]:
        name = case["name"]
        plan = sh.build_mesh(case["axes"], device="cpu")
        base = sharded_params_from_numpy(base_np, plan, cfg)
        before = [t.clone() for t in tr._leaves(base)]
        full = lora_from_numpy(adapter_np, device="cpu")
        specs = tl.lora_shardings(plan, full, cfg)
        adapter = sh.shard_tree(full, specs, plan)
        state = tr.TrainState(params=adapter,
                              opt_state=tr.make_optimizer(args["lr"]).init(adapter),
                              step=torch.zeros((), dtype=torch.int32))
        step = tl.make_sharded_lora_train_step(plan, cfg, adapter, lr=args["lr"],
                                               accum_steps=case["accum"])
        losses = []
        for _ in range(args["steps"]):
            state, loss = step(state, base, sh.local_batch(plan, tokens))
            losses.append(loss.item())
        for part, tree in (("params", state.params), ("mu", state.opt_state.mu),
                           ("nu", state.opt_state.nu)):
            whole = sh.gather_tree(tree, specs, plan)
            arrays.update({f"{name}.{part}.{k}": v for k, v in _flat(whole).items()})
        out[name] = {"losses": losses, "step": int(state.step),
                     "base_unchanged": all(torch.equal(a, b) for a, b in
                                           zip(before, tr._leaves(base))),
                     "base_requires_grad": any(t.requires_grad for t in tr._leaves(base)),
                     "b_local": {t: list(v["b"].shape)
                                 for t, v in state.params["layers"].items()}}
    if rank == 0:
        np.savez(d / "rank0.npz", **arrays)
    return out


@job
def vision_dp(rank, world, d, args):
    """``train_vision`` over {dp: world} from the seed: the loss trace."""
    from tputopo_torch import sharding as sh
    from tputopo_torch import vision as tv

    _init(rank, world, d)
    cfg = tv.VisionConfig(**args["cfg"], compute_dtype=torch.float32)
    plan = sh.build_mesh({"dp": world}, device="cpu")
    losses = tv.train_vision(plan, cfg, steps=args["steps"], batch=args["batch"],
                             lr=args["lr"], seed=args["seed"])
    return {"losses": losses}


def _config(cfg: dict):
    """A ModelConfig from the job's JSON: the model's fields, ``moe`` a dict
    of MoEConfig fields or absent, f32 compute."""
    from tputopo_torch.model import ModelConfig
    from tputopo_torch.moe import MoEConfig

    cfg = dict(cfg)
    moe = cfg.pop("moe", None)
    return ModelConfig(**cfg, moe=MoEConfig(**moe) if moe else None,
                       compute_dtype=torch.float32)


@job
def parallel_step(rank, world, d, args):
    """Per case of ``args["cases"]`` (axes, n_micro, accum, logits, and
    ``cfg`` fields over the job's ``args["cfg"]``, ``params`` the prefix
    of its tree in inputs.npz, "p" by default): the
    sharded forward's logits (gathered whole) and aux, then one sharded
    step from the converted params in inputs.npz, its loss and the updated
    params gathered whole."""
    from tputopo_torch import pipeline
    from tputopo_torch import sharding as sh
    from tputopo_torch import train as tr
    from tputopo_torch.convert import sharded_params_from_numpy
    from tputopo_torch.model import forward_with_aux

    _init(rank, world, d)
    blocks = [0]  # the pipeline's layer calls on this rank
    block = pipeline.transformer_block

    def counted(*a, **kw):
        blocks[0] += 1
        return block(*a, **kw)

    pipeline.transformer_block = counted
    inputs = np.load(d / "inputs.npz")
    tokens = torch.from_numpy(inputs["tokens"])
    out, arrays = {}, {}
    for case in args["cases"]:
        name, n_micro = case["name"], case.get("n_micro")
        tree = case.get("params", "p") + "."
        full = _nest({k[len(tree):]: inputs[k] for k in inputs.files if k.startswith(tree)})
        cfg = _config({**args["cfg"], **case.get("cfg", {})})
        plan = sh.build_mesh(case["axes"], device="cpu")
        specs = tr.state_shardings(plan, cfg)
        params = sharded_params_from_numpy(full, plan, cfg)
        local = sh.local_batch(plan, tokens)
        res = {"local": {k: list(v.shape) for k, v in _flat(params).items()}}
        if case.get("logits"):
            with torch.no_grad(), sh.activate(plan):
                logits, aux = forward_with_aux(params, local, cfg, n_micro=n_micro)
            arrays[f"{name}.logits"] = sh.gather_leaf(
                logits, plan.spec("dp", "sp", None), plan).numpy()
            res["aux"] = aux.item()
        state = tr.TrainState(params=params,
                              opt_state=tr.make_optimizer(args["lr"]).init(params),
                              step=torch.zeros((), dtype=torch.int32))
        step = tr.make_sharded_train_step(plan, cfg, lr=args["lr"], n_micro=n_micro,
                                          accum_steps=case.get("accum", 1))
        blocks[0] = 0
        state, loss = step(state, local)
        res["pipeline_blocks"] = blocks[0]
        gathered = sh.gather_tree(state.params, specs.params, plan)
        arrays.update({f"{name}.{k}": v for k, v in _flat(gathered).items()})
        out[name] = {**res, "loss": loss.item(), "step": int(state.step),
                     "host_staged": dict(sh.HOST_STAGED)}
    if rank == 0:
        np.savez(d / "rank0.npz", **arrays)
    return out


@job
def sp_attention(rank, world, d, args):
    """Per case (axes, fn "ring" or "a2a", impl, causal, kv_group): the
    per-rank attention on this rank's block of q/k/v from inputs.npz (batch
    over dp, sequence over sp, heads over tp), and the grads of
    sum(out * do) in q, k and v; output and grads gathered whole."""
    from tputopo_torch import sharding as sh
    from tputopo_torch.ring import ring_attention
    from tputopo_torch.ulysses import a2a_attention

    _init(rank, world, d)
    inputs = np.load(d / "inputs.npz")
    arrays, out = {}, {}
    for case in args["cases"]:
        name = case["name"]
        plan = sh.build_mesh(case["axes"], device="cpu")
        spec = plan.spec("dp", "sp", "tp", None)
        prefix = case.get("inputs", "")
        q, k, v, do = (sh.shard_leaf(torch.from_numpy(inputs[prefix + n]), spec, plan)
                       for n in ("q", "k", "v", "do"))
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        fn = ring_attention if case["fn"] == "ring" else a2a_attention
        try:
            o = fn(q, k, v, plan, causal=case["causal"], kv_group=case.get("kv_group", 1),
                   impl=case["impl"])
        except ValueError as e:
            out[name] = {"error": str(e)}
            continue
        grads = torch.autograd.grad((o * do).sum(), (q, k, v))
        for n, t in zip(("out", "dq", "dk", "dv"), (o, *grads)):
            arrays[f"{name}.{n}"] = sh.gather_leaf(t.detach(), spec, plan).numpy()
        out[name] = {"local": list(q.shape)}
    if rank == 0:
        np.savez(d / "rank0.npz", **arrays)
    return out


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
