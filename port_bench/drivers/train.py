"""DenseFusion training steps: `train/densefusion.py::estimator_step` and
`refiner_step`, back to back in the traffic's schedule, over a pool of
batches staged on the device, on the one `TrainerState` that
`create_trainer` makes (both networks, both `ClippedAdam`s) and one
dropout generator.

Set-up drives that object through the schedule's first period from the
seed's weights; the reference follows its first three steps from the same
seed. The window then goes on with the same object. At a step drawn from
the seed, some way into the window, where a period of the schedule starts,
the program's state is copied on the device (both networks' parameters,
both optimizers' moments and step counts, the dropout generator's state);
the reference follows the next three steps of the window from that copy.
Of each recorded run of three steps are kept: the losses, each network's
first gradient as its optimizer took it (from Adam's first moment before
and after: m1 = 0.9 m0 + 0.1 g) and the parameters after the three.

The rate counts every sample of every step over the whole window, up to
the moment the device has finished them."""
from __future__ import annotations

import random
import sys
import time
from typing import Dict, List

import torch

from harness import program
from harness import weights as W
from harness.stats import rate
from reference import nets as R
from reference import train as RT
from traffic.batches import batch_pool

CHECKED_STEPS = 3
# where in the window the recorded steps start, as shares of its length
WINDOW_MARK = (0.2, 0.6)


def _pool(cfg: Dict, traffic: Dict, seed: int, device):
    t = cfg["train"]
    return batch_pool(traffic["pool"], t["batch_size"], cfg["crop"],
                      cfg["num_points"], cfg["num_points_mesh"],
                      cfg["num_objects"], traffic["sym_share"], seed + 1,
                      device)


def _dropout_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed + 2)


class Recording:
    """Three steps of the program from step `first`, with the state they
    started from (device copies, read after the window)."""

    def __init__(self, driver: "Driver", fresh: bool):
        self.first = driver.next
        self.kinds: List[str] = []
        self.losses: List[torch.Tensor] = []
        self.generator = driver.generator.get_state()
        self.start, self.m0, self.v0, self.t0 = {}, {}, {}, {}
        self.m1: Dict[str, torch.Tensor] = {}
        self.params: Dict[str, torch.Tensor] = {}
        if fresh:
            return       # the seed's weights and fresh optimizers
        for name, net, opt in driver.nets():
            self.t0[name] = None
            for leaf, p in net.named_parameters():
                key = f"{name}/{leaf}"
                self.start[key] = p.detach().clone()
                s = opt.adam.state.get(p)
                if s:
                    self.m0[key] = s["exp_avg"].clone()
                    self.v0[key] = s["exp_avg_sq"].clone()
                    self.t0[name] = s["step"].clone()

    @property
    def done(self) -> bool:
        return len(self.kinds) == CHECKED_STEPS

    def after(self, driver: "Driver", kind: str, loss) -> None:
        self.kinds.append(kind)
        self.losses.append(loss.detach())
        name, net, opt = driver.net_of(kind)
        if not any(k.startswith(name + "/") for k in self.m1):
            for leaf, p in net.named_parameters():
                m = opt.adam.state.get(p, {}).get("exp_avg")
                self.m1[f"{name}/{leaf}"] = (torch.zeros_like(p) if m is None
                                             else m.clone())
        if self.done:
            for name, net, _ in driver.nets():
                self.params.update({f"{name}/{leaf}": p.detach().clone()
                                    for leaf, p in net.named_parameters()})

    def readings(self) -> RT.Readings:
        """The program's side of the comparison."""
        first = {k: (m1 - 0.9 * self.m0[k]) / 0.1 if k in self.m0
                 else m1 / 0.1 for k, m1 in self.m1.items()}
        return RT.Readings(kinds=list(self.kinds),
                           losses=[float(x) for x in self.losses],
                           first_grad=first, params=self.params)

    def adam(self) -> Dict:
        """{'posenet' / 'refiner': (t, m, v)} to start the reference from."""
        out = {}
        for name, t in self.t0.items():
            if t is None:
                continue
            pre = name + "/"
            out[name] = (int(t.item()),
                         {k[len(pre):]: v for k, v in self.m0.items()
                          if k.startswith(pre)},
                         {k[len(pre):]: v for k, v in self.v0.items()
                          if k.startswith(pre)})
        return out


class Driver:
    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device):
        from autoposeestimation_tpu_torch.train import densefusion as dft

        self.dft = dft
        self.cfg, self.traffic, self.seed, self.device = (cfg, traffic, seed,
                                                          device)
        self.schedule: List[str] = traffic["schedule"]
        self.batches = _pool(cfg, traffic, seed, device)
        self.state = program.trainer(cfg, W.seeded_states(cfg, seed, device),
                                     device)
        self.generator = _dropout_generator(seed, device)
        self.mark = random.Random(seed).uniform(*WINDOW_MARK)
        self.next = 0
        self.first = Recording(self, fresh=True)
        self.in_window = None
        for _ in range(max(len(self.schedule), CHECKED_STEPS)):
            self._step(self.first)

    def kind(self, i: int) -> str:
        return self.schedule[i % len(self.schedule)]

    def nets(self):
        s = self.state
        return (("posenet", s.posenet, s.optimizer),
                ("refiner", s.refiner, s.refine_optimizer))

    def net_of(self, kind: str):
        return self.nets()[0 if kind == "estimator" else 1]

    def _step(self, recording: Recording = None) -> torch.Tensor:
        i = self.next
        self.next += 1
        s, cfg = self.state, self.state.cfg
        b = self.batches[i % len(self.batches)]
        kind = self.kind(i)
        if kind == "estimator":
            loss = self.dft.estimator_step(
                s.posenet, s.optimizer, b, s.w, cfg.with_sym, cfg.sym_bf16,
                generator=self.generator)["loss"]
        else:
            loss = self.dft.refiner_step(s.posenet, s.refiner,
                                         s.refine_optimizer, b, s.w,
                                         cfg.iteration, cfg.with_sym)["dis"]
        if recording is not None and not recording.done:
            recording.after(self, kind, loss)
        return loss

    def window(self, seconds: float) -> Dict:
        outs, first = [], self.next
        t0 = time.perf_counter()
        deadline, mark = t0 + seconds, t0 + self.mark * seconds
        period = len(self.schedule)
        rec = None
        while True:
            now = time.perf_counter()
            if rec is None and now >= mark and self.next % period == 0:
                rec = self.in_window = Recording(self, fresh=False)
            if now >= deadline and rec is not None and rec.done:
                break
            outs.append(self._step(rec))
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()
        end = time.perf_counter()
        finite = torch.isfinite(torch.stack(outs).float())
        steps = len(outs)
        kinds = [self.kind(i) for i in range(first, first + steps)]
        return {"units": steps, "seconds": end - t0,
                "samples": steps * self.cfg["train"]["batch_size"],
                "kinds": {k: kinds.count(k) for k in set(kinds)},
                "attempted": steps, "failed": int((~finite).sum())}

    def end_to_end(self, w: Dict) -> Dict[str, float]:
        return {"train_samples_per_s": rate(w["samples"], w["seconds"])}

    def traced_units(self) -> int:
        n = self.traffic["trace_units"]
        for _ in range(n):
            self._step()
        return n

    def release(self) -> None:
        self.state = None
        self.batches = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def check(self, limits: Dict) -> Dict[str, float]:
        return check_steps(self.cfg, self.traffic, self.seed, self.device,
                           self.first, self.in_window)


def _reference_nets(cfg: Dict, seed: int, device, quant, start=None):
    """The reference networks with the seed's weights, or with `start`
    ({network/leaf: tensor}) over them."""
    R.exact_f32()
    states = W.seeded_states(cfg, seed, device)
    k = cfg["num_objects"]
    with torch.device(device):
        nets = {"posenet": R.PoseNet(k, cfg["train"]["emb_stride"]),
                "refiner": R.PoseRefineNet(k)}
    for name, net in nets.items():
        state = states[name]
        if start is not None:
            pre = name + "/"
            state.update({k[len(pre):]: v.to(device) for k, v in
                          start.items() if k.startswith(pre)})
        net.load_state_dict(state)
        R.set_quant(net, quant)
    return nets["posenet"], nets["refiner"]


def reference_steps(cfg: Dict, traffic: Dict, seed: int, device,
                    quant=None, batch_map=None) -> RT.Readings:
    """The reference (or, with `quant`, the control) through the first
    steps from the seed's weights, batches and dropout draws; `batch_map`
    plants a fault in the batches it is handed."""
    posenet, refiner = _reference_nets(cfg, seed, device, quant)
    batches = _pool(cfg, traffic, seed, device)[:CHECKED_STEPS]
    if batch_map is not None:
        batches = [batch_map(b) for b in batches]
    kinds = [traffic["schedule"][i % len(traffic["schedule"])]
             for i in range(CHECKED_STEPS)]
    return RT.run_steps(posenet, refiner, batches, kinds,
                        _dropout_generator(seed, device), cfg["train"])


def replay_steps(cfg: Dict, traffic: Dict, seed: int, device,
                 rec: Recording, quant=None, batch_map=None) -> RT.Readings:
    """The reference (or the control) through the recorded window steps,
    from the state the program held before them: its parameters, moments,
    step counts and dropout generator, and the pool's batches of those
    steps."""
    posenet, refiner = _reference_nets(cfg, seed, device, quant, rec.start)
    pool = _pool(cfg, traffic, seed, device)
    batches = [pool[(rec.first + j) % len(pool)]
               for j in range(CHECKED_STEPS)]
    if batch_map is not None:
        batches = [batch_map(b) for b in batches]
    generator = torch.Generator(device=device)
    generator.set_state(rec.generator)
    return RT.run_steps(posenet, refiner, batches, rec.kinds, generator,
                        cfg["train"], adam=rec.adam())


def check_steps(cfg, traffic, seed, device, first: Recording,
                in_window: Recording) -> Dict[str, float]:
    """The first steps' numbers, and the window's under `window_` names;
    the worst leaves of each go to the log."""
    if in_window is None or not in_window.done:
        raise RuntimeError("the window recorded no steps")
    out = {}
    for prefix, prog, ref in (
            ("", first.readings(),
             reference_steps(cfg, traffic, seed, device)),
            ("window_", in_window.readings(),
             replay_steps(cfg, traffic, seed, device, in_window))):
        got = RT.compare(prog, ref)
        out.update({prefix + k: v for k, v in got.items()})
        print(f"steps from {in_window.first if prefix else 0}: median leaf "
              f"grad {got['grad_gap_median']:.4g} change "
              f"{got['change_gap_median']:.4g}; worst leaves "
              + RT.worst_leaves(RT.leaf_gaps(prog, ref)), file=sys.stderr)
    return out
