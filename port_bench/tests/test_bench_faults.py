"""`correct` comes out false for the control and for each fault the cell
can have, with the look for a card skipped and the rest of a run driven at
a small size on the CPU; a sound run at the same size comes out true."""
import time
from types import SimpleNamespace

import pytest
import torch

import run as R
import tiny
from harness import controls

SEED = 2 ** 31 + 9


def _run(cell):
    out = R.run(cell, SEED, 0.5, False, "cpu", time.perf_counter())
    return R.is_correct(out["checks"], out["window"]), out["checks"]


@pytest.mark.parametrize("name", ["live.autopose_5obj",
                                  "stream.densefusion_ycb21",
                                  "train.autopose_5obj"])
def test_sound_run_is_correct(name):
    ok, checks = _run(tiny.tiny_cell(name))
    assert ok, checks


def _shift_positions(monkeypatch):
    from autoposeestimation_tpu_torch.pipeline import predict

    real = predict._pose_stage

    def pose_stage(*args, **kwargs):
        quat, trans = real(*args, **kwargs)
        return quat, trans + torch.tensor([0.0, 0.0, 0.05])

    monkeypatch.setattr(predict, "_pose_stage", pose_stage)


@pytest.mark.parametrize("name", ["live.autopose_5obj",
                                  "stream.densefusion_ycb21"])
def test_an_answer_altered_where_produced(name, monkeypatch):
    _shift_positions(monkeypatch)
    ok, checks = _run(tiny.tiny_cell(name))
    assert not ok, checks


def _drop_lanes(monkeypatch, keep):
    """Served frames that return only `keep(names)` of the found classes,
    named from the largest mask to the smallest."""
    from autoposeestimation_tpu_torch.pipeline import predict

    real = predict._materialize

    def materialize(host, models, want_masks=True):
        out = real(host, models, want_masks)
        preds = out["predictions"]
        names = sorted(preds, key=lambda c: -int(preds[c]["mask"].sum()))
        out["predictions"] = {k: preds[k] for k in keep(names)}
        return out

    monkeypatch.setattr(predict, "_materialize", materialize)


def _half_components(monkeypatch):
    """Each class's component cut to the rows that hold its first half."""
    from autoposeestimation_tpu_torch.pipeline import predict

    real = predict._class_mask

    def class_mask(*args, **kwargs):
        comp, found, converged = real(*args, **kwargs)
        rows = comp.sum(-1)
        upper = rows.cumsum(-1) <= rows.sum(-1, keepdim=True) / 2
        return comp & upper[..., None], found, converged

    monkeypatch.setattr(predict, "_class_mask", class_mask)


FAULTS = {"no_predictions": lambda mp: _drop_lanes(mp, lambda n: []),
          "half_the_lanes": lambda mp: _drop_lanes(
              mp, lambda n: n[(len(n) + 1) // 2:]),
          "half_a_component": _half_components}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", ["live.autopose_5obj",
                                  "stream.densefusion_ycb21"])
def test_found_set_and_masks_are_held(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    ok, checks = _run(tiny.tiny_cell(name))
    assert not ok and checks["mass_gap"]["value"] > 0.3, checks
    if fault == "half_a_component":
        assert checks["cell_gap"]["value"] > 0.0, checks


def test_half_of_a_stream_batch_left_out(monkeypatch):
    from autoposeestimation_tpu_torch.pipeline import predict

    real = predict._predict_batch

    def half(models, images, depths, intr, scale, uniforms):
        n = images.shape[0] // 2
        out = real(models, images[:n], depths[:n], intr, scale,
                   uniforms[:n])
        return {k: torch.cat([v, v]) for k, v in out.items()}

    monkeypatch.setattr(predict, "_predict_batch", half)
    ok, checks = _run(tiny.tiny_cell("stream.densefusion_ycb21"))
    assert not ok, checks


def test_a_step_that_leaves_its_state_unchanged(monkeypatch):
    from autoposeestimation_tpu_torch.train import densefusion as dft

    def no_update(self, mesh=None):
        return torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(p.grad) for p in self.params
             if p.grad is not None]))

    monkeypatch.setattr(dft.ClippedAdam, "step", no_update)
    ok, checks = _run(tiny.tiny_cell("train.autopose_5obj"))
    assert not ok and checks["change_gap"]["value"] == pytest.approx(1.0)
    # the median leaf: every leaf at or above it reads 1
    assert checks["window_change_gap_median"]["value"] > 0.9


def test_a_step_inside_the_window_that_goes_wrong(monkeypatch):
    """A fault that starts only once the window runs: from then on every
    step takes half of its batch. The first steps stay sound; the window's
    numbers fail."""
    from autoposeestimation_tpu_torch.train import densefusion as dft

    cell = tiny.tiny_cell("train.autopose_5obj")
    sound = cell.driver().Driver

    class Driver(sound):
        def window(self, seconds):
            for name in ("estimator_step", "refiner_step"):
                monkeypatch.setattr(dft, name, _halved(getattr(dft, name)))
            return super().window(seconds)

    monkeypatch.setattr(cell, "driver", lambda: SimpleNamespace(
        Driver=Driver))
    ok, checks = _run(cell)
    assert checks["loss_gap"]["value"] < checks["loss_gap"]["limit"]
    assert not ok, checks


def _halved(real):
    def half(*args, **kwargs):
        args = list(args)
        i = next(i for i, a in enumerate(args) if isinstance(a, dict))
        n = args[i]["obj_idx"].shape[0] // 2
        args[i] = {k: v[:n] for k, v in args[i].items()}
        return real(*args, **kwargs)
    return half


def test_half_of_a_training_batch_left_out(monkeypatch):
    from autoposeestimation_tpu_torch.train import densefusion as dft

    for name in ("estimator_step", "refiner_step"):
        monkeypatch.setattr(dft, name, _halved(getattr(dft, name)))
    ok, checks = _run(tiny.tiny_cell("train.autopose_5obj"))
    assert not ok, checks


@pytest.mark.parametrize("name", ["live.autopose_5obj",
                                  "stream.densefusion_ycb21"])
def test_serving_control_fails(name):
    cell = tiny.tiny_cell(name)
    values = controls.serve_control(cell, SEED, "cpu")
    checks = R.judge(values, cell.limits)
    assert not R.is_correct(checks, {"failed": 0}), checks


def test_training_control_fails():
    cell = tiny.tiny_cell("train.autopose_5obj")
    values = controls.train_control(cell, SEED, "cpu")
    checks = R.judge(values, cell.limits)
    assert not R.is_correct(checks, {"failed": 0}), checks
