"""The served frame graph's runner (`pipeline/frame_graphs.py`) and the
ImageNet constants it needs resident on the device.

On the CPU (tier-1):
  * `full_prediction` and `serve_stream` at batch 1 and 4 stay eager:
    with tracing on they record the five graph.* spans in every unit, no
    'graph.replay', and count no 'graph_replays' or 'graph_captures'.
  * `normalize_imagenet` gives the old formula's values bit for bit, with
    its constants made inside `inference_mode` and then used by autograd.

On the card (`cuda`, skipped without one), f32 models at 96x128:
  * the replay equals eager `_predict_frame` on the same inputs (masks,
    found, argmax, cca_converged exactly; poses within 1e-4, the serving
    parity tests' tolerance);
  * frames A, B, A give A's outputs both times (no static buffer stale);
  * `serve_stream(batch=4, in_flight=2)` returns, frame by frame, what
    `full_prediction` returns;
  * one signature captures once over 20 frames, a second resolution
    captures a second graph;
  * host draws, draws on the card and `serve_stream(batch=1)`'s f32 depth
    from its pinned ring share one graph with `full_prediction`'s pinned
    copies, and give the same results;
  * models on the last card (made explicit; with more than one card, not
    the current one, after a graph on the current card) replay what eager
    `_predict_frame` gives there, and their stream returns what
    `full_prediction` returns.
"""
import numpy as np
import pytest
import torch

from autoposeestimation_tpu_torch.models import common
from autoposeestimation_tpu_torch.pipeline import frame_graphs
from autoposeestimation_tpu_torch.pipeline import predict
from autoposeestimation_tpu_torch.utils import synthetic, timing
from autoposeestimation_tpu_torch.utils.io import Intrinsics

GRAPH = ["graph.segment", "graph.cca", "graph.crop", "graph.pose",
         "graph.refine"]
K, NPT = 2, 16
ATOL = 1e-4
EXACT = ("found", "masks", "argmax", "cca_converged", "masks_packed")


@pytest.fixture(autouse=True)
def fresh_tracer():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    timing.disable()
    timing.reset()
    yield
    timing.disable()
    timing.reset()
    torch.set_num_threads(n)


def _models(device):
    mp = np.random.default_rng(0).normal(size=(K, 10, 3)).astype(
        np.float32) * 0.05
    return predict.build_models(K, mp, ("ball", "cube"), num_points=NPT,
                                crop=32, dtype=torch.float32, device=device)


def _frames(n, h=48, w=64):
    """n views of two spheres from successive ring cameras (image, depth
    uint16 mm, meta)."""
    cfg = synthetic.SynthConfig(img_h=h, img_w=w, fx=w * 1.7, fy=w * 1.7)
    spheres = [synthetic.SphereObject("ball", np.asarray([40.0, 0.0, 35.0]),
                                      35.0, (200, 40, 40)),
               synthetic.SphereObject("cube", np.asarray([-40.0, 20.0, 30.0]),
                                      30.0, (40, 40, 200))]
    meta = {"intr": Intrinsics(width=w, height=h, ppx=w / 2, ppy=h / 2,
                               fx=cfg.fx, fy=cfg.fy), "depth_scale": 0.001}
    out = []
    for cam in synthetic.ring_cameras(cfg, np.zeros(3))[:n]:
        color, depth, _ = synthetic.render(cfg, cam, spheres)
        out.append((color, np.round(depth).astype(np.uint16), meta))
    return out


def _draws(n):
    rng = np.random.default_rng(7)
    return [rng.random((K, NPT), dtype=np.float32) for _ in range(n)]


def _serve(models, kind, frames, draws):
    if kind == "frame":
        return [predict.full_prediction(*f, models, uniforms=d)
                for f, d in zip(frames, draws)]
    return list(predict.serve_stream(frames, models, in_flight=2,
                                     uniforms=draws, batch=int(kind[-1])))


@pytest.mark.parametrize("kind", ["frame", "stream1", "stream4"])
def test_the_cpu_path_stays_eager(kind):
    models = _models("cpu")
    frames = _frames(5)
    timing.enable()
    outs = _serve(models, kind, frames, _draws(5))
    assert len(outs) == 5
    rec = timing.records()
    assert "graph_replays" not in rec.counters
    assert "graph_captures" not in rec.counters
    units = {s.unit for s in rec.spans
             if s.name in ("frame", "stream.dispatch")}
    assert len(units) == {"frame": 5, "stream1": 5, "stream4": 2}[kind]
    names = {}
    for s in rec.spans:
        names.setdefault(s.name, set()).add(s.unit)
    for name in GRAPH:
        assert names.get(name) == units, name
    assert "graph.replay" not in names
    assert models.seg_model not in frame_graphs._GRAPHS


def _old_normalize(img):
    x = img.to(torch.float32) / 255.0
    stats = torch.tensor((common.IMAGENET_MEAN, common.IMAGENET_STD),
                         dtype=torch.float32)
    return (x - stats[0, :, None, None]) / stats[1, :, None, None]


def test_normalize_imagenet_is_the_old_formula_bit_for_bit(monkeypatch):
    monkeypatch.setattr(common, "_IMAGENET_STATS", {})
    img = torch.as_tensor(np.random.default_rng(0).integers(
        0, 256, (2, 3, 17, 23), dtype=np.uint8))
    with torch.inference_mode():          # the constants are made here
        served = common.normalize_imagenet(img)
    assert torch.equal(served, _old_normalize(img))
    assert torch.equal(common.normalize_imagenet(img[0]),
                       _old_normalize(img[0]))
    x = img.to(torch.float32).requires_grad_()    # autograd saves them
    common.normalize_imagenet(x).sum().backward()
    want = x.detach().clone().requires_grad_()
    _old_normalize(want).sum().backward()
    assert torch.equal(x.grad, want.grad)


# on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs are CUDA's")
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    # full f32: a batch of 4 and one frame then round alike
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield _models("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = (
        tf32)


def _host(out):
    return {name: t.cpu().numpy() for name, t in out.items()}


def _assert_outputs_equal(a, b):
    assert a.keys() == b.keys()
    for name in a:
        if name in EXACT:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)
        else:
            np.testing.assert_allclose(a[name], b[name], rtol=0, atol=ATOL,
                                       err_msg=name)


def _sources(frame, draws):
    return tuple(torch.from_numpy(a)
                 for a in predict._frame_arrays(*frame) + (draws,))


def _assert_replay_is_eager(models, frames, draws):
    dev = models.device
    with torch.inference_mode():
        for frame, d in zip(frames, draws):
            replay = _host(frame_graphs.load(predict._predict_frame, models,
                                             _sources(frame, d))())
            eager = _host(predict._predict_frame(
                models, *predict._frame_inputs(*frame, dev),
                torch.as_tensor(d, device=dev)))
            _assert_outputs_equal(replay, eager)


def _assert_same_predictions(got, want):
    assert len(got) == len(want)
    for s, f in zip(got, want):
        assert s["cca_converged"] == f["cca_converged"]
        assert s["predictions"].keys() == f["predictions"].keys()
        for cls, p in s["predictions"].items():
            q = f["predictions"][cls]
            np.testing.assert_array_equal(p["mask"], q["mask"])
            for key in ("position", "rotation"):
                np.testing.assert_allclose(p[key], q[key], rtol=0,
                                           atol=ATOL)


@pytest.mark.cuda
def test_the_replay_equals_the_eager_frame(card):
    _assert_replay_is_eager(card, _frames(2, 96, 128), _draws(2))


@pytest.mark.cuda
def test_a_b_a_gives_a_both_times(card):
    (a, b), (da, db) = _frames(2, 96, 128), _draws(2)
    with torch.inference_mode():
        outs = [_host(frame_graphs.load(predict._predict_frame, card,
                                        _sources(f, d))())
                for f, d in ((a, da), (b, db), (a, da))]
    _assert_outputs_equal(outs[0], outs[2])
    assert not np.array_equal(outs[0]["argmax"], outs[1]["argmax"])
    assert not np.allclose(outs[0]["positions"], outs[1]["positions"])


@pytest.mark.cuda
def test_the_stream_returns_what_full_prediction_returns(card):
    frames, draws = _frames(9, 96, 128), _draws(9)
    single = _serve(card, "frame", frames, draws)
    assert len(single) == 9
    _assert_same_predictions(_serve(card, "stream4", frames, draws), single)


@pytest.mark.cuda
def test_one_signature_captures_once(card):
    timing.enable()
    frames, draws = _frames(4, 96, 128), _draws(20)
    for i in range(20):
        predict.full_prediction(*frames[i % 4], card, uniforms=draws[i])
    assert timing.records().counters["graph_captures"] == 1
    assert timing.records().counters["graph_replays"] == 20
    predict.full_prediction(*_frames(1, 64, 96)[0], card,
                            uniforms=draws[0])
    assert timing.records().counters["graph_captures"] == 2
    assert len(frame_graphs._GRAPHS[card.seg_model]) == 2


@pytest.mark.cuda
def test_sources_of_either_kind_share_one_graph(card):
    timing.enable()
    frames = [(c, d.astype(np.float32), m)
              for c, d, m in _frames(3, 96, 128)]
    draws = _draws(3)
    first = predict.full_prediction(*frames[0], card, uniforms=draws[0])
    gen = torch.Generator(device="cuda").manual_seed(0)
    predict.full_prediction(*frames[1], card, generator=gen)
    on_card = predict.full_prediction(
        *frames[0], card, uniforms=torch.as_tensor(draws[0], device="cuda"))
    _assert_same_predictions([on_card], [first])
    _assert_same_predictions(
        _serve(card, "stream1", frames, draws),
        [predict.full_prediction(*f, card, uniforms=d)
         for f, d in zip(frames, draws)])
    assert timing.records().counters["graph_captures"] == 1
    assert timing.records().counters["graph_replays"] == 9


@pytest.mark.cuda
def test_models_on_a_card_that_is_not_current(card):
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    models = _models(dev)
    frames, draws = _frames(5, 96, 128), _draws(5)
    # a graph on the current card first, as two served cards in one process
    _assert_replay_is_eager(card, frames[:1], draws[:1])
    _assert_replay_is_eager(models, frames[:2], draws[:2])
    _assert_same_predictions(_serve(models, "stream4", frames, draws),
                             _serve(models, "frame", frames, draws))
    assert torch.cuda.current_device() == 0
