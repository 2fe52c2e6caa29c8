"""The plain reference against the measured package at a small size on the
CPU, in float32: the networks, the frame graph end to end, and the first
training steps."""
import copy

import torch

import tiny
from drivers import train as D
from harness import program, serving
from harness import weights as W
from reference import nets as R
from reference import serve as RS
from reference import train as RT

SEED = 2 ** 31 + 77


def _states(cfg):
    return W.seeded_states(cfg, SEED, "cpu")


def test_reference_imports_nothing_of_the_program():
    import ast
    import os

    ref_dir = os.path.dirname(R.__file__)
    for fname in os.listdir(ref_dir):
        if not fname.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(ref_dir, fname)).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for n in names:
                assert n.split(".")[0] in ("torch", "typing", "math",
                                           "statistics", "__future__"), n


def test_networks_match_the_program():
    from autoposeestimation_tpu_torch.models import densefusion, unet

    cfg = tiny.tiny_cell("live.autopose_5obj").config
    states = _states(cfg)
    ref = W.reference_nets(cfg, "cpu")
    for name, net in ref.items():
        net.load_state_dict(states[name])
    k = cfg["num_objects"]
    prog_u = unet.UNet(k + 1)
    prog_u.load_state_dict(states["unet"])
    x = torch.randn(1, 3, 64, 96, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.allclose(prog_u.eval()(x), ref["unet"].eval()(x),
                              atol=1e-5)
    for stride in (1, 8):
        prog_p = densefusion.PoseNet(k, emb_stride=stride)
        prog_p.load_state_dict(states["posenet"])
        ref_p = R.PoseNet(k, stride)
        ref_p.load_state_dict(states["posenet"])
        g = torch.Generator().manual_seed(1)
        img = torch.randn(2, 3, 32, 32, generator=g)
        cloud = torch.randn(2, 50, 3, generator=g) * 0.05
        choose = torch.randint(0, 32 * 32, (2, 50), generator=g)
        obj = torch.tensor([0, 1])
        a = prog_p(img, cloud, choose, obj, train=True,
                   generator=torch.Generator().manual_seed(5))
        b = ref_p(img, cloud, choose, obj, torch.Generator().manual_seed(5))
        for u, v in zip(a, b):
            assert torch.allclose(u, v, atol=1e-5)
    prog_r = densefusion.PoseRefineNet(k)
    prog_r.load_state_dict(states["refiner"])
    emb = torch.randn(2, 50, 32)
    for u, v in zip(prog_r(cloud, emb, obj), ref["refiner"](cloud, emb, obj)):
        assert torch.allclose(u, v, atol=1e-6)


def test_frame_graph_matches_the_program():
    from autoposeestimation_tpu_torch.pipeline import predict

    cell = tiny.tiny_cell("live.autopose_5obj")
    cfg = cell.config
    pool = serving.Pool(cfg, cell.traffic, SEED, "cpu")
    models = program.prediction_models(cfg, _states(cfg), pool.model_points,
                                       "cpu")
    judge = serving.reference_judge(cfg, SEED, pool.model_points, "cpu",
                                    serving.tie_margin(cell.limits))
    for i in range(2):
        frame = pool.frame(i, "cpu")
        with torch.no_grad():
            out = predict._predict_frame(
                models, frame["image"], frame["depth"], frame["intr"],
                frame["depth_scale"], frame["uniforms"])
        ref = RS.frame_outputs(judge.nets, frame, cfg)
        assert torch.equal(out["found"], ref["found"])
        assert bool(out["found"].any())
        assert torch.equal(out["masks"], ref["masks"])
        live = out["found"]
        assert torch.allclose(out["positions"][live],
                              ref["positions"][live], atol=1e-5)
        served = serving.served_arrays(predict._materialize(
            {k: out[k].numpy() for k in ("found", "quats", "positions",
                                         "cca_converged", "masks")},
            models), cfg["num_objects"], cfg["image_hw"])
        got = judge.judge(frame, served)
        assert got["seg_gap"] == 0.0 and got["mass_gap"] < 1e-6, got
        assert got["cell_gap"] == 0.0, got
        assert got["pose_err"] < 1e-5


def _tight(got):
    assert got["loss_gap"] < 1e-5, got
    assert got["grad_gap"] < 1e-4, got
    # Adam moves an element by about lr whatever its gradient's size, so
    # elements whose gradient is nought to rounding move either way: the
    # change agrees to 1e-3, not to float32's rounding
    assert got["change_gap"] < 1e-3, got


def test_training_steps_match_the_program():
    """The first steps from the seed, and three steps of the window from
    the state the program held before them."""
    cell = tiny.tiny_cell("train.autopose_5obj")
    cfg = copy.deepcopy(cell.config)
    cfg["train"]["sym_bf16"] = False
    d = D.Driver(cfg, cell.traffic, SEED, "cpu")
    _tight(RT.compare(d.first.readings(),
                      D.reference_steps(cfg, cell.traffic, SEED, "cpu")))
    begin = d.next
    w = d.window(0.3)
    rec = d.in_window
    assert rec.done and begin <= rec.first <= begin + w["units"] - 3
    assert rec.adam()["posenet"][0] >= begin - 1
    _tight(RT.compare(rec.readings(), D.replay_steps(
        cfg, cell.traffic, SEED, "cpu", rec)))


def test_symmetric_loss_matches_the_program():
    from autoposeestimation_tpu_torch.models import losses

    from reference import pose as P

    g = torch.Generator().manual_seed(3)
    b, n, m = 2, 20, 30
    pred_r = torch.randn(b, n, 4, generator=g, requires_grad=True)
    pred_t = (torch.randn(b, n, 3, generator=g) * 0.01).requires_grad_()
    pred_c = torch.rand(b, n, 1, generator=g)
    target = torch.randn(b, m, 3, generator=g) * 0.05
    model = torch.randn(b, m, 3, generator=g) * 0.05
    points = torch.randn(b, n, 3, generator=g) * 0.05
    sym = torch.tensor([True, False])
    a = losses.pose_loss(pred_r, pred_t, pred_c, target, model, points, sym)
    r = P.pose_loss(pred_r, pred_t, pred_c, target, model, points, sym,
                    0.015)
    assert torch.allclose(a.loss, r.loss, rtol=1e-5)
    ga = torch.autograd.grad(a.loss, (pred_r, pred_t))
    gr = torch.autograd.grad(r.loss, (pred_r, pred_t))
    for u, v in zip(ga, gr):
        assert torch.allclose(u, v, atol=1e-6)
