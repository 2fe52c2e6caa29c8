"""The port's SegNet (`models/segnet.py`) and its training step
(`train/vanilla_segnet.py::train_step`) held against the benchmark's plain
reference (`port_bench/reference/segnet.py`, loaded here by its path),
DenseFusion's published SegNet, its loss and Adam in plain float32, on the
CPU at 64x64, batch 2, from seeded random weights in flax's convention.

  * float32: the train-mode logits, the loss and every leaf's gradient of
    the first step, and the parameters after each of three Adam steps
    (the reference's Adam from the port's state and gradients), to float32
    round-off.
  * bfloat16 against the float32 reference: the loss, each convolution
    stack (and the head) alone on the port's own input and output gradient,
    and the same three Adam steps. Through the whole network a bfloat16
    rounding grows from layer to layer (the logits read tens of per cent
    apart), so elements are compared stack by stack; the reference
    computed with float8 operands (`fp8_round`) fails those tolerances.
  * Spans: `train_step` records one 'step' unit (kind 'segnet') of
    'step.forward', 'step.backward' and 'step.optimizer', and five
    'segnet.pool' and five 'segnet.unpool' spans in its forward, while
    tracing is on, and nothing while it is off.
  * `init_like_flax`, as `train_vanilla_segnet` initialises SegNet: every
    kernel a LeCun normal truncated at two standard deviations, zero
    biases, unit BatchNorm.
"""
import importlib.util
import math
import os
import statistics

import pytest
import torch

from autoposeestimation_tpu_torch.models import segnet
from autoposeestimation_tpu_torch.models.common import init_like_flax
from autoposeestimation_tpu_torch.train import vanilla_segnet
from autoposeestimation_tpu_torch.utils import timing


def _plain_reference():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "port_bench", "reference", "segnet.py")
    spec = importlib.util.spec_from_file_location("plain_segnet", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


P = _plain_reference()
B, H, W, CLASSES, STEPS = 2, 64, 64, 22, 3
LR = 1e-4
STACKS = ([f"encoder.{i}" for i in range(5)]
          + [f"decoder.{i}" for i in range(5)] + ["head"])

# float32: the same convolutions and BatchNorm arithmetic on the same CPU;
# the port's loss is log_softmax and a gather, the reference's
# F.cross_entropy, which round alike to a few ulps
F32_TOL = 1e-5
# bfloat16 against float32. The loss averages 8,192 pixels and reads
# 0.1-0.2 % apart (the logits 60 %); each stack alone reads 0.5-1 % apart
# at its output (bf16's 2^-9 through two or three convolutions) and a few %
# at its median leaf's gradient; float8 operands (2^-4 forward, 2^-3
# backward) read about 10x that
BF16_LOSS = 1e-2
BF16_STACK_OUT = 0.03
BF16_STACK_GRAD_MEDIAN = 0.08
# Adam's update from the same gradients and state: float32 round-off of a
# parameter (BatchNorm's scales sit at 1, whose ulp is 1.2e-7)
ADAM_RTOL, ADAM_ATOL = 1e-6, 1e-9


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads: the suite runs six workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batches():
    g = torch.Generator().manual_seed(7)
    return [{"image": torch.randn(B, 3, H, W, generator=g),
             "label": torch.randint(0, CLASSES, (B, H, W), generator=g)}
            for _ in range(STEPS)]


def _built(make, state):
    net = make()
    net.load_state_dict(state)
    return net


@pytest.fixture(scope="module")
def initial():
    """Seeded random weights in flax's convention (LeCun-normal kernels,
    zero biases, unit BatchNorm)."""
    with torch.device("meta"):
        shapes = segnet.SegNet(CLASSES).state_dict()
    g = torch.Generator().manual_seed(3)
    state = {}
    for k, v in shapes.items():
        if k.endswith("weight") and v.dim() == 4:
            fan_in = v.shape[1] * v.shape[2] * v.shape[3]
            state[k] = torch.randn(v.shape, generator=g) / fan_in ** 0.5
        elif k.endswith(("weight", "running_var")):
            state[k] = torch.ones(v.shape)
        else:
            state[k] = torch.zeros(v.shape)
    return state


def _rel(a, b):
    return float((a.double() - b.double()).norm()
                 / b.double().norm().clamp(min=1e-30))


class Capture:
    """Each stack's input, output and output gradient, and the network's
    logits, in one forward and backward of `net` (port or reference: the
    stacks have the same names)."""

    def __init__(self, net):
        self.inputs, self.outputs, self.grads = {}, {}, {}
        self.handles = [net.get_submodule(n).register_forward_hook(
            self._hook(n)) for n in STACKS]
        self.handles.append(net.register_forward_hook(self._logits))

    def _hook(self, name):
        def keep(grad):
            self.grads[name] = grad.detach().clone()

        def hook(_module, args, out):
            self.inputs[name] = args[0].detach().clone()
            self.outputs[name] = out.detach().clone()
            out.register_hook(keep)
        return hook

    def _logits(self, _module, _args, out):
        self.logits = out.detach().clone()

    def remove(self):
        for h in self.handles:
            h.remove()


def _reference(initial, quant=None):
    return P.set_quant(_built(lambda: P.SegNet(CLASSES), initial), quant)


@pytest.fixture(scope="module")
def reference(initial):
    """The reference and its first step: {net, logits, loss, grads {leaf:
    gradient}}."""
    net = _reference(initial)
    b = _batches()[0]
    logits = net(b["image"])
    loss = P.cross_entropy(logits, b["label"])
    params = dict(net.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    return {"net": net, "logits": logits.detach(),
            "loss": float(loss.detach()), "grads": dict(zip(params, grads))}


def _adam_gap(before, state, grads, after, t):
    """The worst leaf's |after - reference| over ADAM_ATOL + ADAM_RTOL *
    |reference|, the reference's Adam stepping from `before` and `state`
    (Adam's per-leaf state before step `t`) with `grads`."""
    params = {k: v.clone() for k, v in before.items()}
    P.Adam(params, LR, t - 1,
           {k: s["exp_avg"] for k, s in state.items()},
           {k: s["exp_avg_sq"] for k, s in state.items()}).step(grads)
    return max(float(((after[k] - p).abs()
                      / (ADAM_ATOL + ADAM_RTOL * p.abs())).max())
               for k, p in params.items())


def _port_steps(initial, dtype):
    """Three `train_step`s of the port: the first step's loss, gradients
    and capture, and each step's `_adam_gap`."""
    model = _built(lambda: segnet.SegNet(CLASSES, dtype), initial)
    opt = torch.optim.Adam(model.parameters(), lr=LR, betas=(0.9, 0.999),
                           eps=1e-8)
    named = dict(model.named_parameters())
    capture, out = Capture(model), {"adam_gaps": []}
    for t, b in enumerate(_batches(), 1):
        before = {k: p.detach().clone() for k, p in named.items()}
        state = {k: {s: v.clone() for s, v in opt.state[p].items()}
                 for k, p in named.items() if p in opt.state}
        loss = float(vanilla_segnet.train_step(model, opt, b))
        grads = {k: p.grad for k, p in named.items()}
        if t == 1:
            capture.remove()
            out.update(loss=loss, grads=grads, capture=capture)
        out["adam_gaps"].append(_adam_gap(
            before, state, grads, {k: p.detach() for k, p in named.items()},
            t))
    return out


@pytest.fixture(scope="module")
def port(initial):
    """dtype name -> `_port_steps` in that dtype, run once."""
    runs = {}

    def get(dtype):
        if dtype not in runs:
            runs[dtype] = _port_steps(initial, getattr(torch, dtype))
        return runs[dtype]
    return get


def test_float32_step_matches_the_reference(port, reference):
    run = port("float32")
    logits, loss, grads = (reference[k] for k in ("logits", "loss", "grads"))
    assert _rel(run["capture"].logits, logits) <= F32_TOL
    assert abs(run["loss"] - loss) <= F32_TOL * loss
    med = statistics.median(float(g.norm()) for g in grads.values())
    for k, g in grads.items():
        gap = float((run["grads"][k] - g).norm()) / max(float(g.norm()), med)
        assert gap <= F32_TOL, k


def test_bfloat16_loss_is_the_references(port, reference):
    loss = reference["loss"]
    assert abs(port("bfloat16")["loss"] - loss) <= BF16_LOSS * loss


def stack_gaps(capture, prog_grads, ref):
    """(worst stack output gap, median leaf gradient gap) of the stacks of
    a run against the float32 reference `ref`'s stacks alone on that run's
    own stack inputs and output gradients."""
    outs, diffs, norms = [], {}, {}
    for name in STACKS:
        module = ref.get_submodule(name)
        params = dict(module.named_parameters())
        y = module(capture.inputs[name].float())
        g = torch.autograd.grad(y, list(params.values()),
                                capture.grads[name].float())
        outs.append(_rel(capture.outputs[name].float(), y.detach()))
        for leaf, gr in zip(params, g):
            key = f"{name}.{leaf}"
            diffs[key] = float((prog_grads[key] - gr).norm())
            norms[key] = float(gr.norm())
    med = statistics.median(norms.values())
    return max(outs), statistics.median(
        diffs[k] / max(norms[k], med) for k in norms)


@pytest.mark.parametrize("run", ["bfloat16 port", "float8 reference"])
def test_stacks_alone_hold_bfloat16_and_not_float8(run, port, reference,
                                                    initial):
    """The port in bfloat16 meets the stack tolerances; the reference with
    float8 operands, held the same way, misses at least one."""
    if run == "bfloat16 port":
        bf16 = port("bfloat16")
        capture, grads = bf16["capture"], bf16["grads"]
    else:
        net = _reference(initial, P.fp8_round)
        capture = Capture(net)
        b = _batches()[0]
        P.cross_entropy(net(b["image"]), b["label"]).backward()
        capture.remove()
        grads = {k: p.grad for k, p in net.named_parameters()}
    out_gap, grad_median = stack_gaps(capture, grads, reference["net"])
    held = out_gap <= BF16_STACK_OUT and grad_median <= BF16_STACK_GRAD_MEDIAN
    assert held == (run == "bfloat16 port"), (out_gap, grad_median)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_adam_steps_are_the_references(dtype, port):
    """Each step's parameters: the reference's Adam from the port's state
    before the step, with the port's gradients."""
    assert max(port(dtype)["adam_gaps"]) <= 1.0


@pytest.mark.parametrize("on", [True, False])
def test_train_step_spans(on, initial):
    model = _built(lambda: segnet.SegNet(CLASSES), initial)
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    timing.reset()
    if on:
        timing.enable()
    try:
        vanilla_segnet.train_step(model, opt, _batches()[0])
    finally:
        timing.disable()
    rec = timing.records()
    timing.reset()
    if not on:
        assert rec.spans == [] and rec.counters == {}
        return
    (step,) = [s for s in rec.spans if s.name == "step"]
    assert step.attrs == {"kind": "segnet"}
    assert all(s.unit == step.unit for s in rec.spans)
    kids = {s.name: s for s in rec.spans if s.parent == step.id}
    assert set(kids) == {"step.forward", "step.backward", "step.optimizer"}
    assert (kids["step.forward"].end_ns <= kids["step.backward"].start_ns
            and kids["step.backward"].end_ns
            <= kids["step.optimizer"].start_ns)
    pools = [s for s in rec.spans if s.name.startswith("segnet.")]
    assert sorted(s.name for s in pools) == (["segnet.pool"] * 5
                                             + ["segnet.unpool"] * 5)
    assert all(s.parent == kids["step.forward"].id for s in pools)


def test_init_like_flax_draws_truncated_lecun_kernels():
    """The draw `train_vanilla_segnet` starts from, at the published widths:
    each kernel's standard deviation sqrt(1 / fan-in) within 5 % (the
    smallest kernel, 1,728 values, reads about 1.4 % off by chance; torch's
    default init reads 42 % under), its mean within 0.15 of that (0.024 by
    chance), no value beyond two of the untruncated normal's standard
    deviations; zero biases; BatchNorm scales 1 and statistics (0, 1)."""
    model = segnet.SegNet(CLASSES)
    init_like_flax(model, torch.Generator().manual_seed(5))
    for k, v in model.state_dict().items():
        if k.endswith("weight") and v.dim() == 4:
            std = math.sqrt(1.0 / (v.shape[1] * v.shape[2] * v.shape[3]))
            assert abs(float(v.std()) / std - 1) < 0.05, k
            assert abs(float(v.mean())) < 0.15 * std, k
            assert float(v.abs().max()) <= 2 * std / 0.87962566103423978 * (
                1 + 1e-6), k
        else:
            one = (".bns." in k and k.endswith(".weight")
                   or k.endswith(".running_var"))
            assert torch.equal(v, torch.full_like(v, 1.0 if one else 0.0)), k
