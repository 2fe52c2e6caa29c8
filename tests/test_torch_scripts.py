"""The port's scripts (`autoposeestimation_tpu_torch/scripts/`) against
the JAX package's `scripts/`, loaded by file path, on the CPU: the demo's
scene families and the held-out cameras equal; `gate_symbf16`'s verdict
line equal on the repo's recorded artifacts (read, never written);
`stream_logs`' terminal summary and `view_data`'s panels equal; and
`train_multi_demo` run end to end at its smallest size, whose artifact has
the JAX demo's keys and lands under `--out`."""
import hashlib
import importlib.util
import json
import os
import sys

import numpy as np
import pytest

from autoposeestimation_tpu.utils import io as jio
from autoposeestimation_tpu_torch.scripts import (attribute_serving,
                                                  gate_symbf16, stream_logs,
                                                  train_multi_demo,
                                                  view_data)
from autoposeestimation_tpu_torch.utils import io, synthetic
from test_torch_seg_models import two_threads  # noqa: F401  (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
ART = os.path.join(REPO, "artifacts")


def jax_script(name, monkeypatch):
    """The JAX package's `scripts/<name>.py` as a module (its siblings
    importable, as when it runs from there)."""
    monkeypatch.syspath_prepend(SCRIPTS)
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(SCRIPTS, name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def artifacts_digest():
    h = hashlib.sha256()
    for name in sorted(os.listdir(ART)):
        h.update(name.encode())
        with open(os.path.join(ART, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def fields(obj):
    return {k: (np.asarray(v).tolist() if isinstance(v, np.ndarray) else v)
            for k, v in vars(obj).items()}


@pytest.mark.parametrize("family", ["a", "b"])
@pytest.mark.parametrize("img_hw", [(480, 640), (120, 160)])
def test_scene_families_equal_jax(monkeypatch, family, img_hw):
    jdemo = jax_script("train_multi_demo", monkeypatch)
    jcfg, jobjects = jdemo.SCENE_FAMILIES[family](12, img_hw)
    cfg, objects = train_multi_demo.SCENE_FAMILIES[family](12, img_hw)
    assert fields(cfg) == fields(jcfg)
    assert [fields(o) for o in objects] == [fields(o) for o in jobjects]
    for name in ("MULTI_IMG_HW", "MULTI_NUM_PT", "MULTI_CROP",
                 "MULTI_SYM_CLASS"):
        assert getattr(train_multi_demo, name) == getattr(jdemo, name)
    # the renders agree pixel for pixel
    cam = synthetic.ring_cameras(cfg, np.zeros(3))[5]
    got = synthetic.render(cfg, cam, objects)
    jsynth = sys.modules[type(jcfg).__module__]
    want = jsynth.render(jcfg, cam, jobjects)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_heldout_cameras_and_iou_equal_jax(monkeypatch):
    jattr = jax_script("attribute_serving", monkeypatch)
    for family in ("a", "b"):
        cfg, _ = train_multi_demo.SCENE_FAMILIES[family](48, (480, 640))
        np.testing.assert_array_equal(
            np.stack(attribute_serving.heldout_cameras(cfg, 7)),
            np.stack(jattr.heldout_cameras(cfg, 7)))
    rng = np.random.default_rng(0)
    a, b = rng.random((2, 30, 40)) > 0.5
    assert attribute_serving.iou(a, b) == jattr.iou(a, b)
    assert attribute_serving.iou(a & False, b & False) == 0.0


GATE_CASES = {
    "demo_tables": [],
    "attribution_tables": [
        "--exact-serve", os.path.join(ART, "serving_attribution_round5.json"),
        "--twin-serve", os.path.join(ART, "serving_symbf16_round5.json")],
    "tight": ["--tol-add-mm", "0.1", "--tol-serve-mm", "0.5"],
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_gate_symbf16_verdict_equals_jax(monkeypatch, capsys, case):
    before = artifacts_digest()
    args = ["--exact", os.path.join(ART, "demo_multi_round5.json"),
            "--exact-curves",
            os.path.join(ART, "demo_multi_round5_curves.json"),
            "--twin", os.path.join(ART, "demo_multi_round5_symbf16.json"),
            "--twin-curves",
            os.path.join(ART, "demo_multi_round5_symbf16_curves.json"),
            *GATE_CASES[case]]
    jgate = jax_script("gate_symbf16", monkeypatch)
    monkeypatch.setattr(sys, "argv", ["gate_symbf16.py", *args])
    want_rc = jgate.main()
    want = capsys.readouterr().out
    got_rc = gate_symbf16.main(args)
    got = capsys.readouterr().out
    assert got == want and got_rc == want_rc
    assert json.loads(got)["gate"] == "sym_bf16_promotion"
    assert artifacts_digest() == before


def test_gate_symbf16_refuses_one_file_as_both(monkeypatch, capsys):
    same = os.path.join(ART, "demo_multi_round5.json")
    curves = os.path.join(ART, "demo_multi_round5_curves.json")
    args = ["--exact", same, "--exact-curves", curves, "--twin", same,
            "--twin-curves", curves]
    jgate = jax_script("gate_symbf16", monkeypatch)
    monkeypatch.setattr(sys, "argv", ["gate_symbf16.py", *args])
    assert jgate.main() == gate_symbf16.main(args) == 2
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1] and "error" in json.loads(out[0])


def test_gate_symbf16_needs_its_inputs(capsys):
    with pytest.raises(SystemExit):
        gate_symbf16.main(["--exact", "a.json"])


def test_stream_logs_summary_equals_jax(monkeypatch, capsys, tmp_path):
    from autoposeestimation_tpu_torch.utils.timing import JsonCurveLog

    path = str(tmp_path / "logs" / "losses.json")
    log = JsonCurveLog(path, {"lr": 1e-4})
    for i in range(3):
        log.append(losses=0.5 / (i + 1), test_dists=0.03 - 0.001 * i)
    log.set(note="x")
    monkeypatch.delenv("DISPLAY", raising=False)
    jlogs = jax_script("stream_logs", monkeypatch)
    outs = []
    for main in (lambda: jlogs.main(),
                 lambda: stream_logs.main([path, "--once"])):
        monkeypatch.setattr(sys, "argv", ["stream_logs.py", path, "--once"])
        main()
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "losses=0.1667 (n=3)" in outs[0]
    stream_logs.main([str(tmp_path / "missing.json"), "--once"])
    assert capsys.readouterr().out == "(no curves yet)\n"


def test_view_data_panels_equal_jax(monkeypatch, tmp_path):
    root = str(tmp_path / "ws")
    cfg = synthetic.SynthConfig(img_h=48, img_w=64, fx=60.0, fy=60.0,
                                n_viewpoints=3)
    synthetic.make_dataset(root, objects=[synthetic.SphereObject(
        "ball", np.asarray([0.0, 0.0, 30.0]), 30.0, (200, 40, 40))], cfg=cfg)
    jview = jax_script("view_data", monkeypatch)
    monkeypatch.setattr(sys, "argv", ["view_data.py", root, "ball",
                                      "--dump-dir", str(tmp_path / "jax")])
    jview.main()
    view_data.main([root, "ball", "--dump-dir", str(tmp_path / "port")])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names and names == sorted(os.listdir(tmp_path / "port"))
    for name in names:
        np.testing.assert_array_equal(
            io.read_color(str(tmp_path / "port" / name)),
            jio.read_color(str(tmp_path / "jax" / name)))


def key_tree(d):
    return {k: key_tree(v) if isinstance(v, dict) else None
            for k, v in d.items()}


def test_train_multi_demo_end_to_end(two_threads,  # noqa: F811
                                    tmp_path, capsys):
    """The smallest run on the CPU: 1 segmentation and 2 pose epochs (the
    refine phase reached by its epoch fallback), 3 views an object at
    96x128, 16 points, crop 32. Its artifact lands under --out with the
    JAX demo's keys (the repo's record of a full run); a class the served
    frames miss has no ADD keys in either package."""
    before = artifacts_digest()
    out = str(tmp_path / "demo")
    results = train_multi_demo.main([
        "--out", out, "--device", "cpu", "--img-h", "96", "--img-w", "128",
        "--viewpoints", "3", "--seg-epochs", "1", "--pose-epochs", "2",
        "--num-pt", "16", "--crop", "32"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert [x["stage"] for x in lines] == ["dataset", "segmentation",
                                           "pose_training", "eval",
                                           "serving"]
    art = io.read_json(os.path.join(out, "demo_multi.json"))
    assert art == json.loads(json.dumps(results))
    assert os.path.exists(os.path.join(out, "demo_multi_curves.json"))
    assert artifacts_digest() == before

    want = key_tree(io.read_json(os.path.join(ART, "demo_multi_round5.json")))
    got = key_tree(art)
    assert got.keys() == want.keys()
    for section in ("segmentation", "eval"):
        assert got[section].keys() == want[section].keys()
    assert got["pose_training"].keys() == want["pose_training"].keys()
    assert art["platform"] == "cpu" and art["pose_training"]["with_sym"]
    assert got["serving"].keys() == want["serving"].keys()
    for cls, row in got["serving"]["per_class"].items():
        full = want["serving"]["per_class"][cls]
        assert row.keys() <= full.keys()
        if art["serving"]["per_class"][cls]["found"]:
            assert row.keys() == full.keys()
    for table in ("estimator_only", "with_refine"):
        for cls, row in want["eval"][table].items():
            assert got["eval"][table][cls].keys() == row.keys()
