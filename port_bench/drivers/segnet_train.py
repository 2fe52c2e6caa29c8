"""DenseFusion's vanilla SegNet trained on labelled 640x480 views:
`train/vanilla_segnet.py::train_step`, back to back over a pool of batches
staged on the device as `train/segmentation.py::to_device` stages them, on
one `SegNet` with `train_vanilla_segnet`'s `torch.optim.Adam`. Its weights
are the seed's, drawn by the benchmark (`harness/segnet_weights.py`, in
the convention `train_vanilla_segnet` draws them in) and loaded into the
program and the reference alike. The loss is read on the host after every
step, as `train_vanilla_segnet` logs it.

Set-up drives that pair through the pool's first three steps. In the first,
forward hooks keep each convolution stack's (and the head's) input, output
and the loss's gradient by that output. The reference
(`reference/segnet.py`, float32) follows the three steps from the seed's
weights (`compare`), and takes each stack alone on the program's input and
output gradient (`stack_gaps`): the whole network amplifies a rounding
from layer to layer, a stack alone does not. At a step drawn from the
seed, some way into the window, the program's parameters and Adam's
moments and step count are copied on the device; the reference follows
the next three steps from that copy (`window_*`). Of each run of three
steps are kept: the losses, the first gradient (from Adam's first moment
before and after: m1 = 0.9 m0 + 0.1 g) and the parameters after the
three. Which of these numbers the cell judges, and why, is in its limits
file.

The rate counts every sample of every step over the whole window, up to
the moment the device has finished them."""
from __future__ import annotations

import math
import random
import statistics
import sys
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from harness.program import DTYPES
from harness.segnet_weights import seeded_state
from harness.stats import rate
from reference import segnet as RS
from reference.train import _leaf_gaps, _norm
from traffic import seg_frames

CHECKED_STEPS = 3
# where in the window the recorded steps start, as shares of its length
WINDOW_MARK = (0.2, 0.6)
# a leaf whose reference gradient is below this share of the median leaf's
# is moved by Adam's round-off alone and is left out of change_gap
MOVED = 1e-3


def views(cfg: Dict, traffic: Dict, seed: int, device) -> Dict:
    return seg_frames.labelled_views(
        traffic["layout"], tuple(cfg["image_hw"]),
        traffic["pool"] * cfg["batch_size"], seed + 1, device)


def plain_pool(cfg: Dict, traffic: Dict, seed: int, device
               ) -> List[Dict[str, torch.Tensor]]:
    """The pool's batches as the reference takes them: image (B, 3, H, W),
    label (B, H, W)."""
    v, b = views(cfg, traffic, seed, device), cfg["batch_size"]
    return [{"image": v["image"][i:i + b].permute(0, 3, 1, 2).contiguous(),
             "label": v["label"][i:i + b]}
            for i in range(0, v["label"].shape[0], b)]


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def stack_names(net: torch.nn.Module) -> List[str]:
    return ([f"encoder.{i}" for i in range(len(net.encoder))]
            + [f"decoder.{i}" for i in range(len(net.decoder))] + ["head"])


class StackCapture:
    """Each stack's input and output in one step of the program, and the
    gradient of the loss by that output, copied to the host (so that the
    window's device memory holds only what training holds): forward hooks,
    removed by `remove`."""

    def __init__(self, model: torch.nn.Module):
        self.inputs: Dict[str, torch.Tensor] = {}
        self.outputs: Dict[str, torch.Tensor] = {}
        self.grads: Dict[str, torch.Tensor] = {}
        self.handles = [model.get_submodule(name).register_forward_hook(
            self._hook(name)) for name in stack_names(model)]

    def _hook(self, name: str):
        def keep(grad):
            self.grads[name] = _host(grad)

        def hook(_module, args, out):
            self.inputs[name] = _host(args[0])
            self.outputs[name] = _host(out)
            out.register_hook(keep)
        return hook

    def remove(self) -> None:
        for h in self.handles:
            h.remove()
        self.handles = []


def tie_share(y: torch.Tensor) -> float:
    """The share of the 2x2 pooling windows of `y` (B, C, H, W) whose
    maximum, above 0, two or more positions share."""
    b, c, h, w = y.shape
    win = y.reshape(b, c, h // 2, 2, w // 2, 2).permute(
        0, 1, 2, 4, 3, 5).reshape(b, c, h // 2, w // 2, 4)
    top = win.amax(-1, keepdim=True)
    return float((((win == top).sum(-1) > 1) & (top[..., 0] > 0))
                 .float().mean())


class Recording:
    """Three steps of the program from step `first`, with the state they
    started from (device copies, read after the window)."""

    def __init__(self, driver: "Driver", fresh: bool):
        self.first = driver.next
        self.losses: List[float] = []
        self.start: Dict[str, torch.Tensor] = {}
        self.m0: Dict[str, torch.Tensor] = {}
        self.v0: Dict[str, torch.Tensor] = {}
        self.t0 = 0
        self.m1: Dict[str, torch.Tensor] = {}
        self.params: Dict[str, torch.Tensor] = {}
        if fresh:
            return       # the seed's weights and a fresh optimizer
        for leaf, p in driver.model.named_parameters():
            self.start[leaf] = p.detach().clone()
            s = driver.optimizer.state[p]
            self.m0[leaf] = s["exp_avg"].clone()
            self.v0[leaf] = s["exp_avg_sq"].clone()
            self.t0 = int(s["step"])

    @property
    def done(self) -> bool:
        return len(self.losses) == CHECKED_STEPS

    def after(self, driver: "Driver", loss: float) -> None:
        self.losses.append(loss)
        named = list(driver.model.named_parameters())
        if len(self.losses) == 1:
            self.m1 = {leaf: driver.optimizer.state[p]["exp_avg"].clone()
                       for leaf, p in named}
        if self.done:
            self.params = {leaf: p.detach().clone() for leaf, p in named}

    def readings(self) -> Dict:
        """The program's side of the comparison."""
        first = {k: (m1 - 0.9 * self.m0[k]) / 0.1 if k in self.m0
                 else m1 / 0.1 for k, m1 in self.m1.items()}
        return {"losses": list(self.losses), "first_grad": first,
                "params": self.params}

    def adam(self) -> Dict:
        """{'t', 'm', 'v'} to start the reference's Adam from."""
        return {"t": self.t0, "m": self.m0, "v": self.v0}


class Driver:
    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device):
        from autoposeestimation_tpu_torch.models import segnet
        from autoposeestimation_tpu_torch.train import vanilla_segnet
        from autoposeestimation_tpu_torch.train.segmentation import to_device

        published = (tuple(map(tuple, cfg["encoder_widths"])),
                     tuple(map(tuple, cfg["decoder_widths"])))
        if published != (segnet.ENCODER_WIDTHS, segnet.DECODER_WIDTHS):
            raise ValueError("the program's SegNet is not at the "
                             "configuration's widths")
        self.train_step = vanilla_segnet.train_step
        self.cfg, self.traffic, self.seed, self.device = (cfg, traffic, seed,
                                                          device)
        v, b = views(cfg, traffic, seed, device), cfg["batch_size"]
        self.batches = [to_device({"image": v["image"][i:i + b],
                                   "label": v["label"][i:i + b]}, device)
                        for i in range(0, v["label"].shape[0], b)]
        self.initial = seeded_state(cfg, seed, device)
        self.model = segnet.SegNet(classes=cfg["classes"],
                                   dtype=DTYPES[cfg["dtype"]]).to(device)
        self.model.load_state_dict(self.initial)
        self.optimizer = torch.optim.Adam(
            self.model.parameters(), lr=float(np.float32(cfg["lr"])),
            betas=tuple(cfg["betas"]), eps=cfg["eps"])
        self.mark = random.Random(seed).uniform(*WINDOW_MARK)
        self.next = 0
        self.first = Recording(self, fresh=True)
        self.in_window = None
        self.capture = StackCapture(self.model)
        self._step(self.first)
        self.capture.remove()
        while not self.first.done:
            self._step(self.first)
        if torch.device(device).type == "cuda":
            # the peak is the window's: the set-up's copies for the check
            # are no part of training
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

    def _step(self, recording: Recording = None) -> float:
        i = self.next
        self.next += 1
        loss = float(self.train_step(self.model, self.optimizer,
                                     self.batches[i % len(self.batches)]))
        if recording is not None and not recording.done:
            recording.after(self, loss)
        return loss

    def window(self, seconds: float) -> Dict:
        steps = failed = 0
        t0 = time.perf_counter()
        deadline, mark = t0 + seconds, t0 + self.mark * seconds
        rec = None
        while True:
            now = time.perf_counter()
            if rec is None and now >= mark:
                rec = self.in_window = Recording(self, fresh=False)
            if now >= deadline and rec is not None and rec.done:
                break
            failed += not math.isfinite(self._step(rec))
            steps += 1
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()
        end = time.perf_counter()
        return {"units": steps, "seconds": end - t0,
                "samples": steps * self.cfg["batch_size"],
                "kinds": {"segnet": steps}, "attempted": steps,
                "failed": failed}

    def end_to_end(self, w: Dict) -> Dict[str, float]:
        return {"train_samples_per_s": rate(w["samples"], w["seconds"])}

    def traced_units(self) -> int:
        n = self.traffic["trace_units"]
        for _ in range(n):
            self._step()
        return n

    def release(self) -> None:
        self.model = self.optimizer = self.batches = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def check(self, limits: Dict) -> Dict[str, float]:
        return check_steps(self.cfg, self.traffic, self.seed, self.device,
                           self.initial, self.first, self.in_window,
                           self.capture)


def reference_net(cfg: Dict, state: Dict[str, torch.Tensor], device,
                  quant=None) -> RS.SegNet:
    RS.exact_f32()
    with torch.device(device):
        net = RS.SegNet(cfg["classes"])
    net.load_state_dict(state)
    return RS.set_quant(net, quant)


def reference_steps(cfg: Dict, traffic: Dict, seed: int, device,
                    initial: Dict, rec: Recording = None, quant=None,
                    batch_map: Callable = None) -> Dict:
    """The reference (or, with `quant`, the control) through the recorded
    steps: from the seed's weights (`initial`) and a fresh Adam, or from
    the state the program held before `rec`'s steps; `batch_map` plants a
    fault in the batches it is handed."""
    start = dict(initial)
    if rec is not None:
        start.update(rec.start)
    net = reference_net(cfg, start, device, quant)
    pool = plain_pool(cfg, traffic, seed, device)
    first = 0 if rec is None else rec.first
    batches = [pool[(first + j) % len(pool)] for j in range(CHECKED_STEPS)]
    if batch_map is not None:
        batches = [batch_map(b) for b in batches]
    return RS.run_steps(net, batches, cfg["lr"],
                        None if rec is None else rec.adam())


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """loss_gap: the worst step's relative loss gap; grad_gap: the worst
    leaf's gap of first-gradient norms; change_gap: the worst leaf's gap of
    the norms of the parameters' change over the steps, over the leaves
    whose reference first gradient is at least `MOVED` of the median
    leaf's; and the median leaf's of both. Gaps of norms, not norms of
    differences: the network amplifies a rounding from layer to layer, so
    that the program's and the reference's gradients agree in size and not
    element by element (`stack_gaps` compares elements)."""
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30)
                   for p, r in zip(prog["losses"], ref["losses"]))
    g_ref = {k: _norm(g) for k, g in ref["first_grad"].items()}
    grad = _leaf_gaps({k: _norm(prog["first_grad"][k]) for k in g_ref},
                      g_ref)
    med = statistics.median(g_ref.values())
    moved = [k for k in ref["params"] if g_ref[k] >= MOVED * med]
    d_ref = {k: _norm(ref["params"][k] - ref["start"][k]) for k in moved}
    d_prog = {k: _norm(prog["params"][k] - ref["start"][k]) for k in moved}
    change = _leaf_gaps(d_prog, d_ref)
    print("worst leaves: grad " + ", ".join(
        f"{k} {v:.4g}" for k, v in sorted(grad.items(),
                                          key=lambda kv: -kv[1])[:3])
          + "; change " + ", ".join(
        f"{k} {v:.4g}" for k, v in sorted(change.items(),
                                          key=lambda kv: -kv[1])[:3]),
          file=sys.stderr)
    return {"loss_gap": loss_gap, "grad_gap": max(grad.values()),
            "change_gap": max(change.values()),
            "grad_gap_median": statistics.median(grad.values()),
            "change_gap_median": statistics.median(change.values())}


def stack_outputs(net: torch.nn.Module, capture: StackCapture):
    """Each stack of `net` alone on the captured input, differentiated by
    the captured output gradient: yields (name, output, {leaf:
    gradient})."""
    device = net.head.weight.device
    for name in stack_names(net):
        module = net.get_submodule(name)
        x = capture.inputs[name].to(device, torch.float32)
        params = dict(module.named_parameters())
        out = module(x)
        grads = torch.autograd.grad(
            out, list(params.values()),
            capture.grads[name].to(device, torch.float32))
        yield name, out.detach(), {f"{name}.{k}": g for k, g in
                                   zip(params, grads)}


def stack_gaps(prog, ref) -> Dict[str, float]:
    """stack_gap: the worst stack's |prog - ref| / |ref| of its output;
    stack_grad_gap and stack_grad_gap_median: the worst and the median
    leaf's |prog - ref| of its gradient over max(|ref|, the median leaf's
    |ref|). `prog` and `ref` yield what
    `stack_outputs` yields, stack by stack."""
    out_gaps, diffs, norms, ties = {}, {}, {}, []
    for (name, y_p, g_p), (_, y_r, g_r) in zip(prog, ref):
        y_p = y_p.to(y_r.device, torch.float32)
        out_gaps[name] = _norm(y_p - y_r) / max(_norm(y_r), 1e-30)
        if name.startswith("encoder."):
            ties.append(f"{name} {tie_share(y_p):.3g} / "
                        f"{tie_share(y_r):.3g}")
        for k, g in g_r.items():
            diffs[k], norms[k] = _norm(g_p[k] - g), _norm(g)
    med = statistics.median(norms.values())
    grad_gaps = {k: diffs[k] / max(norms[k], med, 1e-30) for k in norms}
    worst = max(grad_gaps, key=grad_gaps.get)
    print(f"stacks alone: worst output {max(out_gaps, key=out_gaps.get)} "
          f"{max(out_gaps.values()):.4g}, worst leaf {worst} "
          f"{grad_gaps[worst]:.4g}, median leaf "
          f"{statistics.median(grad_gaps.values()):.4g}; tied pooling "
          "windows above 0, these / the reference's: " + ", ".join(ties),
          file=sys.stderr)
    return {"stack_gap": max(out_gaps.values()),
            "stack_grad_gap": grad_gaps[worst],
            "stack_grad_gap_median": statistics.median(grad_gaps.values())}


def program_stacks(capture: StackCapture, first_grad: Dict, net_names):
    """The program's side of `stack_gaps`: its captured outputs and its
    first gradients."""
    for name in net_names:
        pre = name + "."
        yield name, capture.outputs[name], {
            k: g for k, g in first_grad.items() if k.startswith(pre)}


def check_steps(cfg, traffic, seed, device, initial: Dict, first: Recording,
                in_window: Recording, capture: StackCapture
                ) -> Dict[str, float]:
    """The first steps' numbers, the stacks' and the window's under
    `window_` names."""
    if in_window is None or not in_window.done:
        raise RuntimeError("the window recorded no steps")
    out = {}
    for prefix, rec in (("", first), ("window_", in_window)):
        got = compare(rec.readings(),
                      reference_steps(cfg, traffic, seed, device, initial,
                                      None if rec is first else rec))
        out.update({prefix + k: v for k, v in got.items()})
        print(f"steps from {rec.first}: loss {got['loss_gap']:.4g}, median "
              f"leaf grad {got['grad_gap_median']:.4g} change "
              f"{got['change_gap_median']:.4g}", file=sys.stderr)
    net = reference_net(cfg, initial, device)
    out.update(stack_gaps(
        program_stacks(capture, first.readings()["first_grad"],
                       stack_names(net)),
        stack_outputs(net, capture)))
    return out
