"""The port's jitted training steps -- ``make_sharded_train_step``,
``make_sharded_lora_train_step`` and ``make_vision_train_step``, each a
DONATED compiled program (a CUDA-graph capture through
tputopo_torch._graphs, the reference's ``donate_argnums``) -- on the CPU.

A donated program's first call is its warm-up, which does the call's work
in place (nothing cloned, nothing restored); its capture computes nothing;
later calls replay.  The CPU has no graphs, so the capture logic runs
through a stand-in whose replay re-runs the body on the static input
buffers.  Through it, three calls of each step equal three eager steps bit
for bit (the first call's state is exactly one step's, not zero or two),
one capture serves the three calls (the step counter advances in place,
so the bound storage stays the same), and the steps equal the reference's
jitted steps at the reference tests' tolerances.  Without the stand-in's
NCCL stand-in, a plan over gloo is never graphed: its step runs eagerly,
decided before the call.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp

from tests.torch_parity import adam_state, to_torch, train_state_to_torch, world_of_one
from tputopo.workloads import lora as jl
from tputopo.workloads import model as jm
from tputopo.workloads import train as jt
from tputopo.workloads import vision as jv
from tputopo.workloads.sharding import build_mesh as jax_mesh
from tputopo_torch import _graphs
from tputopo_torch import lora as tl
from tputopo_torch import model as tm
from tputopo_torch import sharding as sh
from tputopo_torch import train as tr
from tputopo_torch import vision as tv
from tputopo_torch.convert import lora_from_numpy, vision_params_from_numpy

torch.set_num_threads(1)

BASE = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=64, max_seq=32)
JCFG = jm.ModelConfig(**BASE, compute_dtype=jnp.float32)
TCFG = tm.ModelConfig(**BASE, compute_dtype=torch.float32)
VISION = dict(image_size=16, widths=(8, 16), d_hidden=32)
VJCFG = jv.VisionConfig(**VISION, compute_dtype=jnp.float32)
VTCFG = tv.VisionConfig(**VISION, compute_dtype=torch.float32)
# The reference's train-step tolerance for the loss and the updated
# parameters (tests/test_workloads.py) and its grad tolerance for the AdamW
# moments, which are made of grads (tests/test_attention.py:90).
TOL, GRAD_TOL = 2e-5, 5e-5
LR, CALLS = 1e-2, 3


def _tokens(seed=0, shape=(2, 16)):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 64, shape))


def _vision_batch():
    images, labels = jv.synthetic_batch(VJCFG, 8, 2)
    return (images, labels), (torch.from_numpy(np.array(images)),
                              torch.from_numpy(np.array(labels)))


# ---- the donated path, through a stand-in graph ----------------------------

class _StandInGraph:
    """Replays by re-running the body on the static input buffers, and
    writes what it returns into the outputs the capture handed out, as a
    CUDA graph rewrites its pool tensors."""

    def __init__(self, body, inputs, outputs):
        self.body, self.inputs, self.outputs = body, inputs, outputs

    def replay(self):
        out = self.body(*self.inputs)
        for dst, src in zip(_graphs.tensors(self.outputs), _graphs.tensors(out)):
            dst.copy_(src)


def _stand_in_capture_donated(self, name, body, device, inputs, generator, bound_sig):
    """Programs._capture_donated on the CPU: the warm-up on static buffers
    is the call's work (nothing put back), and the capture hands out
    outputs of the warm-up's shapes without computing anything."""
    static_in = tuple(t.clone() for t in inputs)
    first = body(*static_in)
    outputs = torch.empty_like(first)
    self.captures[name] += 1
    graph = _StandInGraph(body, static_in, outputs)
    return _graphs._Entry(bound_sig, graph, static_in, outputs, {}, generator), first


@pytest.fixture
def stand_in(monkeypatch):
    """The CUDA path of _graphs on CPU tensors, every process group taken
    for NCCL's, with stand-in graphs."""
    monkeypatch.setattr(_graphs, "graphed", lambda device: True)
    monkeypatch.setattr(_graphs, "replays", lambda device, groups=(): True)
    monkeypatch.setattr(_graphs.Programs, "_capture_donated", _stand_in_capture_donated)


def _snapshot(*trees) -> list:
    return [t.clone() for t in _graphs.tensors(trees)]


def _equal(a: list, b: list) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _model_runs(plan):
    """(eager states and losses after 0..CALLS steps, the jitted step's
    states and losses after each call, the step) for the model."""
    tokens = _tokens()
    ref = tr.make_train_state(TCFG, 3, lr=LR, device="cpu")
    eager = [(_snapshot(ref), None)]
    for _ in range(CALLS):
        ref, loss = tr.train_step(ref, tokens, TCFG, lr=LR)
        eager.append((_snapshot(ref), loss.item()))
    state = tr.make_sharded_state(plan, TCFG, 3, lr=LR)
    step = tr.make_sharded_train_step(plan, TCFG, lr=LR)
    jitted = []
    for _ in range(CALLS):
        state, loss = step(state, tokens)
        jitted.append((_snapshot(state), loss.item()))
    return eager, jitted, step


def _lora_runs(plan):
    tokens = _tokens(1)
    base = tm.init_params(TCFG, 0, device="cpu")
    adapter = tl.init_lora(TCFG, 1, rank=4, device="cpu")
    ref = tr.TrainState(params=adapter, opt_state=tr.make_optimizer(LR).init(adapter),
                        step=torch.zeros((), dtype=torch.int32))
    eager = [(_snapshot(ref), None)]
    for _ in range(CALLS):
        ref, loss = tl.lora_train_step(ref, base, tokens, TCFG, lr=LR)
        eager.append((_snapshot(ref), loss.item()))
    state = tl.make_sharded_lora_state(plan, TCFG, 1, rank=4, lr=LR)
    step = tl.make_sharded_lora_train_step(plan, TCFG, state.params, lr=LR)
    before = _snapshot(base)
    jitted = []
    for _ in range(CALLS):
        state, loss = step(state, base, tokens)
        jitted.append((_snapshot(state), loss.item()))
    assert _equal(before, _snapshot(base))  # the bound base is never written
    return eager, jitted, step


def _vision_runs(plan):
    _, (images, labels) = _vision_batch()
    params = tv.init_vision_params(VTCFG, 0, device="cpu")
    opt = tr.Adam(lr=LR)
    opt_state = opt.init(params)
    eager = [(_snapshot(params, opt_state), None)]
    for _ in range(CALLS):
        loss = tv.vision_train_step(params, opt_state, images, labels, VTCFG, opt)
        eager.append((_snapshot(params, opt_state), loss.item()))
    params = tv.init_vision_params(VTCFG, 0, device="cpu")
    step, opt = tv.make_vision_train_step(plan, VTCFG, lr=LR)
    opt_state = opt.init(params)
    jitted = []
    for _ in range(CALLS):
        params, opt_state, loss = step(params, opt_state, images, labels)
        jitted.append((_snapshot(params, opt_state), loss.item()))
    return eager, jitted, step


RUNS = {"model": _model_runs, "lora": _lora_runs, "vision": _vision_runs}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_jitted_step_equals_eager_steps_bit_for_bit(stand_in, name):
    """Call k of the jitted step leaves the state of k eager steps bit for
    bit, and returns step k's loss: the first call did the work exactly
    once (its state is neither the initial one nor two steps'), and each
    replay did one step.  One capture, two replays."""
    with world_of_one():
        plan = sh.build_mesh({"dp": 1, "tp": 1}, device="cpu")
        eager, jitted, step = RUNS[name](plan)
    for k, (state, loss) in enumerate(jitted, start=1):
        assert _equal(state, eager[k][0]), k
        assert loss == eager[k][1], k
        assert not _equal(state, eager[k - 1][0])
        if k < CALLS:
            assert not _equal(state, eager[k + 1][0])
    assert isinstance(step.programs, _graphs.Programs)
    program = next(iter(step.programs.captures))
    assert step.programs.captures[program] == 1
    assert step.programs.replays[program] == CALLS - 1


def test_one_capture_needs_the_counter_in_place(stand_in):
    """The step counter is the same tensor after every call, advanced in
    place: the bound storage never changes, so three calls capture once.
    A state at other storage recaptures."""
    tokens = _tokens()
    with world_of_one():
        plan = sh.build_mesh({"dp": 1, "tp": 1}, device="cpu")
        state = tr.make_sharded_state(plan, TCFG, 0, lr=LR)
        counter = state.step
        step = tr.make_sharded_train_step(plan, TCFG, lr=LR)
        for i in range(CALLS):
            state, _ = step(state, tokens)
            assert state.step is counter and int(counter) == i + 1
        assert step.programs.captures["train_step"] == 1
        other = tr.make_sharded_state(plan, TCFG, 0, lr=LR)
        step(other, tokens)
    assert step.programs.captures["train_step"] == 2


def test_jitted_steps_check_ids_on_entry(stand_in):
    """Ids are checked where they enter the static buffer: a bad id raises
    before anything runs, and the state is untouched."""
    with world_of_one():
        plan = sh.build_mesh({"dp": 1, "tp": 1}, device="cpu")
        state = tr.make_sharded_state(plan, TCFG, 0, lr=LR)
        before = _snapshot(state)
        bad = torch.tensor([[1, 2, 64, 3]])
        with pytest.raises(ValueError, match="token ids"):
            tr.make_sharded_train_step(plan, TCFG, lr=LR)(state, bad)
        lora_state = tl.make_sharded_lora_state(plan, TCFG, 1, rank=2, lr=LR)
        base = tm.init_params(TCFG, 0, device="cpu")
        with pytest.raises(ValueError, match="token ids"):
            tl.make_sharded_lora_train_step(plan, TCFG, lora_state.params)(lora_state, base,
                                                                           bad)
    assert _equal(before, _snapshot(state))


@pytest.mark.parametrize("name", sorted(RUNS))
def test_gloo_plans_run_eagerly(monkeypatch, name):
    """Under gloo the step is not graphed, decided before the call: with
    the CUDA path taken and every capture refused, a plan over gloo runs
    its steps eagerly, equal to the eager steps bit for bit."""

    def refuse(self, *a, **k):
        raise AssertionError("a gloo step was captured")

    monkeypatch.setattr(_graphs, "graphed", lambda device: True)
    monkeypatch.setattr(_graphs.Programs, "_capture_donated", refuse)
    with world_of_one():
        plan = sh.build_mesh({"dp": 1, "tp": 1}, device="cpu")
        assert not _graphs.replays("cpu", plan.groups())
        eager, jitted, step = RUNS[name](plan)
    assert all(_equal(s, eager[k][0]) and loss == eager[k][1]
               for k, (s, loss) in enumerate(jitted, start=1))
    assert not step.programs.captures and not step.programs.replays


# ---- against the reference's jitted steps -----------------------------------

def _close(got_tree, want_tree, tol):
    for got, want in zip(tr._leaves(got_tree), jax.tree.leaves(want_tree)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


def _check_state(tstate, jstate):
    _close(tstate.params, jstate.params, TOL)
    adam = adam_state(jstate)
    _close(tstate.opt_state.mu, adam.mu, GRAD_TOL)
    _close(tstate.opt_state.nu, adam.nu, GRAD_TOL)
    assert int(tstate.step) == int(jstate.step) == CALLS
    assert int(tstate.opt_state.count) == int(adam.count) == CALLS


def test_model_step_matches_the_reference(stand_in):
    """Three calls of the port's jitted sharded step at {dp: 1, tp: 1} and
    of the reference's make_sharded_train_step on a one-device mesh, from
    the same state: the losses, the params and both AdamW moments."""
    tokens = _tokens(4)
    jplan = jax_mesh({"dp": 1}, devices=jax.devices()[:1])
    jstate = jt.make_sharded_state(jplan, JCFG, jax.random.key(0), lr=LR)
    tstate = train_state_to_torch(jstate)
    jstate = jax.tree.map(jnp.copy, jstate)  # the reference's step donates it
    jstep = jt.make_sharded_train_step(jplan, JCFG, lr=LR)
    with world_of_one():
        plan = sh.build_mesh({"dp": 1, "tp": 1}, device="cpu")
        tstep = tr.make_sharded_train_step(plan, TCFG, lr=LR)
        for _ in range(CALLS):
            jstate, jloss = jstep(jstate, jnp.asarray(tokens.numpy()))
            tstate, tloss = tstep(tstate, tokens)
            assert tloss.item() == pytest.approx(float(jloss), rel=TOL)
    _check_state(tstate, jstate)
    assert tstep.programs.captures["train_step"] == 1


def test_lora_step_matches_the_reference(stand_in):
    """The same for the adapter step over a raw base: the reference's
    make_sharded_lora_train_step on a one-device mesh, from the same
    adapter (its b drawn nonzero, so the delta shows from step 1)."""
    tokens = _tokens(5)
    jbase = jm.init_params(JCFG, jax.random.key(0))
    jlora = jl.init_lora(JCFG, jax.random.key(1), rank=4)
    for i, t in enumerate(jl.DEFAULT_TARGETS):
        jlora["layers"][t]["b"] = jax.random.normal(
            jax.random.key(2 + i), jlora["layers"][t]["b"].shape) * 0.02
    tlora = lora_from_numpy(jax.tree.map(np.asarray, jlora), device="cpu")
    jplan = jax_mesh({"dp": 1}, devices=jax.devices()[:1])
    jstep = jl.make_sharded_lora_train_step(jplan, JCFG, jlora, lr=LR)
    jstate = jt.TrainState(params=jax.tree.map(jnp.copy, jlora),
                           opt_state=jt.make_optimizer(LR).init(jlora),
                           step=jnp.zeros((), jnp.int32))
    tstate = tr.TrainState(params=tlora, opt_state=tr.make_optimizer(LR).init(tlora),
                           step=torch.zeros((), dtype=torch.int32))
    tbase = to_torch(jbase)
    with world_of_one():
        plan = sh.build_mesh({"dp": 1, "tp": 1}, device="cpu")
        tstep = tl.make_sharded_lora_train_step(plan, TCFG, tlora, lr=LR)
        for _ in range(CALLS):
            jstate, jloss = jstep(jstate, jbase, jnp.asarray(tokens.numpy()))
            tstate, tloss = tstep(tstate, tbase, tokens)
            assert tloss.item() == pytest.approx(float(jloss), rel=TOL)
    _check_state(tstate, jstate)
    assert tstep.programs.captures["lora_train_step"] == 1


def test_vision_step_matches_the_reference(stand_in):
    """The same for the classifier's step with no plan against the
    reference's make_vision_train_step on a one-device mesh: the loss
    trace, the params (its conv kernels turned HWIO -> OIHW) and Adam's
    moments."""
    (jimages, jlabels), (images, labels) = _vision_batch()
    jparams = jv.init_vision_params(VJCFG, jax.random.key(0))
    tparams = vision_params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    jplan = jax_mesh({"dp": 1}, devices=jax.devices()[:1])
    jstep, jopt = jv.make_vision_train_step(jplan, VJCFG, lr=LR)
    jstate = jopt.init(jparams)
    jparams = jax.tree.map(jnp.copy, jparams)  # the reference's step donates them
    tstep, topt = tv.make_vision_train_step(None, VTCFG, lr=LR)
    tstate = topt.init(tparams)
    for _ in range(CALLS):
        jparams, jstate, jloss = jstep(jparams, jstate, jimages, jlabels)
        tparams, tstate, tloss = tstep(tparams, tstate, images, labels)
        assert tloss.item() == pytest.approx(float(jloss), rel=TOL)
    turn = {n: (lambda w: w.transpose(3, 2, 0, 1)) if n.startswith("conv") else (lambda w: w)
            for n in tparams}
    for name, got in tparams.items():
        np.testing.assert_allclose(got.numpy(), turn[name](np.asarray(jparams[name])),
                                   rtol=TOL, atol=TOL)
    mu, nu = jstate[0].mu, jstate[0].nu
    for name in tparams:
        for got, want in ((tstate.mu[name], mu[name]), (tstate.nu[name], nu[name])):
            np.testing.assert_allclose(got.numpy(), turn[name](np.asarray(want)),
                                       rtol=GRAD_TOL, atol=GRAD_TOL)
    assert int(tstate.count) == int(jstate[0].count) == CALLS
    assert tstep.programs.captures["vision_train_step"] == 1
