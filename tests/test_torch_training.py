"""The port's DenseFusion training against the JAX package on the CPU, f32,
at a small size (2 objects, crop 32, N=64, M=48): one estimator step and
one refiner step against the JAX package's loss, `jax.value_and_grad` and
optax optimizer, dropout off on both sides (flax's masks cannot be drawn in
torch); dropout itself; the phase machine; and `train()` through both
phases, whose `pose_model.npz` the JAX package loads."""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from autoposeestimation_tpu.models import densefusion as jdf
from autoposeestimation_tpu.models import losses as jlosses
from autoposeestimation_tpu.train import checkpoints as jcheckpoints
from autoposeestimation_tpu.train import densefusion as jdft
from autoposeestimation_tpu_torch import weights
from autoposeestimation_tpu_torch.models import densefusion, pspnet
from autoposeestimation_tpu_torch.train import checkpoints
from autoposeestimation_tpu_torch.train import densefusion as dft
from autoposeestimation_tpu_torch.utils.timing import JsonCurveLog
from test_torch_models import init_vars

B, CROP, N, M, NUM_OBJ = 2, 32, 64, 48, 2
LR, W = 1e-4, 0.015
ATOL = 2e-4   # network outputs, the torch-vs-flax figure


def make_batch(seed):
    """A numpy batch in the JAX package's layout (img channels last), one
    symmetric and one non-symmetric sample at camera depth."""
    rng = np.random.default_rng(seed)
    model = (rng.normal(size=(B, M, 3)) * 0.05).astype(np.float32)
    q = rng.normal(size=(B, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    rot = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (w * y + x * z)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (w * x + y * z),
                  1 - 2 * (x * x + y * y)], -1)], -2)
    trans = rng.normal(size=(B, 3)) * 0.02 + [0.0, 0.0, 0.6]
    target = np.einsum("bmj,bij->bmi", model, rot) + trans[:, None]
    cloud = target[:, rng.integers(0, M, N)] + rng.normal(size=(B, N, 3)) \
        * 0.002
    return {
        "img": np.ascontiguousarray(np.moveaxis(
            rng.normal(size=(B, 3, CROP, CROP)), 1, -1)).astype(np.float32),
        "cloud": cloud.astype(np.float32),
        "choose": rng.integers(0, CROP * CROP, (B, N)).astype(np.int32),
        "target": target.astype(np.float32),
        "model_points": model,
        "obj_idx": np.arange(B, dtype=np.int32) % NUM_OBJ,
        "is_sym": np.arange(B) % 2 == 0,
        "target_t": trans.astype(np.float32),
    }


def jax_args(batch):
    return batch["img"], batch["cloud"], batch["choose"], batch["obj_idx"]


@pytest.fixture(scope="module")
def setup():
    """Random JAX variables for both networks, one batch, and the JAX
    estimator loss, gradients and forward outputs of that batch (one
    compile)."""
    jpose = jdf.PoseNet(num_obj=NUM_OBJ, dtype=jnp.float32)
    jref = jdf.PoseRefineNet(num_obj=NUM_OBJ, dtype=jnp.float32)
    batch = make_batch(0)
    img, cloud, choose, obj = jax_args(batch)
    pose_vars = init_vars(jpose, img, cloud, choose, obj, seed=1)
    ref_vars = init_vars(jref, cloud, np.zeros((B, N, 32), np.float32), obj,
                         seed=2)
    rest = {k: jnp.asarray(batch[k])
            for k in ("target", "model_points", "cloud", "is_sym")}

    @jax.jit
    def value_and_grad(params):
        def loss_fn(p):
            pred_r, pred_t, pred_c, emb = jpose.apply(
                {**pose_vars, "params": p}, img, cloud, choose, obj,
                train=False)
            out = jlosses.pose_loss(pred_r, pred_t, pred_c, rest["target"],
                                    rest["model_points"], rest["cloud"],
                                    rest["is_sym"], w=W, with_sym=True,
                                    sym_bf16=False)
            return out.loss, (out, emb)
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    (loss, (est, emb)), grads = value_and_grad(pose_vars["params"])
    return dict(jpose=jpose, jref=jref, batch=batch, pose_vars=pose_vars,
                ref_vars=ref_vars, loss=float(loss), grads=grads, est=est,
                emb=emb)


def port_posenet(variables):
    net = densefusion.PoseNet(NUM_OBJ)
    net.load_state_dict(weights.posenet_state_dict(variables))
    net.cnn.dropout_rates = (0.0, 0.0, 0.0)
    return net


@functools.partial(jax.jit, static_argnums=2)
def optax_step(params, grads, clip):
    tx = jdft.make_optimizer(LR, clip)
    updates, _ = tx.update(grads, tx.init(params), params)
    return optax.apply_updates(params, updates)


def leaves(tree, like):
    """(path, leaf of `tree`, leaf of `like`) over the paths of `like`."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(like)[0]:
        node = tree
        for p in path:
            node = node[p.key]
        yield path, np.asarray(node), np.asarray(leaf)


def assert_grads_close(net, plan, want_grads, scale, what):
    """The gradients the optimizer saw (clipped by `scale`) against JAX's,
    leaf by leaf within 1e-4 of the leaf's largest entry (f32 sums in
    another order)."""
    got = weights.to_variables({k: p.grad for k, p in net.named_parameters()},
                               plan)["params"]
    for path, g, w_ in leaves(got, want_grads):
        w_ = w_ * scale
        np.testing.assert_allclose(g, w_, atol=1e-4 * max(
            np.abs(w_).max(), 1e-6), err_msg=f"{what} grad {path}")


def assert_updated_close(got_vars, before, want, what):
    """Adam's first step moves each parameter by lr * g / (|g| + 1e-8):
    about lr wherever |g| >> 1e-8. The moves agree within 2 % of lr except
    where |g| is so small that the frameworks' f32 rounding of g is
    comparable to Adam's eps (at most 1 element in 10^5 of a leaf), and
    within the 2 lr that bounds any move everywhere."""
    for path, w_, node0 in leaves(want, before):
        g = got_vars["params"]
        for p in path:
            g = g[p.key]
        got_move, want_move = g - node0, w_ - node0
        off = np.abs(got_move - want_move)
        assert (off > 0.02 * LR).mean() <= 1e-5, (what, path, off.max())
        assert off.max() <= 2 * LR, (what, path, off.max())


@pytest.mark.parametrize("clip_case", ["under", "over"])
def test_estimator_step_matches_jax(setup, clip_case):
    gnorm = float(optax.global_norm(setup["grads"]))
    # "over" puts the norm above the clip, so optax's formula scales
    clip = {"under": 2.0 * gnorm, "over": gnorm / 4.0}[clip_case]
    params = setup["pose_vars"]["params"]
    want = optax_step(params, setup["grads"], clip)

    net = port_posenet(setup["pose_vars"])
    opt = dft.make_optimizer(net.parameters(), LR, clip)
    metrics = dft.estimator_step(
        net, opt, dft.to_device(setup["batch"], "cpu"), W, with_sym=True,
        sym_bf16=False, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(metrics["loss"].item(), setup["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(metrics["gnorm"].item(), gnorm, rtol=1e-4)
    np.testing.assert_allclose(metrics["dis"].item(),
                               float(jnp.mean(setup["est"].dis)), rtol=1e-5)
    # the clip scaled the gradients the optimizer saw
    seen = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(p.grad) for p in net.parameters()]))
    np.testing.assert_allclose(seen.item(), min(gnorm, clip), rtol=1e-4)
    assert_grads_close(net, weights.posenet_plan(), setup["grads"],
                       min(1.0, clip / gnorm), "posenet")
    assert_updated_close(weights.posenet_variables(net), params, want,
                         "posenet")


def test_refiner_step_matches_jax(setup):
    jref, ref_vars, est = setup["jref"], setup["ref_vars"], setup["est"]
    batch = setup["batch"]
    model, is_sym, obj = (jnp.asarray(batch[k])
                          for k in ("model_points", "is_sym", "obj_idx"))

    def loss_fn(params):
        new_points, new_target = est.new_points, est.new_target
        total, dis = 0.0, None
        for _ in range(2):
            dr, dt = jref.apply({**ref_vars, "params": params}, new_points,
                                setup["emb"], obj)
            mean_dis, dis, new_points, new_target = jlosses.refine_loss(
                dr, dt, new_target, model, new_points, is_sym)
            total = total + mean_dis
        return total, dis

    (_, dis), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        ref_vars["params"])
    want = optax_step(ref_vars["params"], grads, 10.0)

    net = port_posenet(setup["pose_vars"])
    refiner = densefusion.PoseRefineNet(NUM_OBJ)
    refiner.load_state_dict(weights.refiner_state_dict(ref_vars))
    opt = dft.make_optimizer(refiner.parameters(), LR)
    metrics = dft.refiner_step(net, refiner, opt,
                               dft.to_device(batch, "cpu"), W, iteration=2)
    np.testing.assert_allclose(metrics["dis"].item(), float(jnp.mean(dis)),
                               rtol=1e-5)
    assert all(p.grad is None for p in net.parameters())
    assert_grads_close(refiner, weights.refiner_plan(), grads,
                       min(1.0, 10.0 / float(optax.global_norm(grads))),
                       "refiner")
    assert_updated_close(weights.refiner_variables(refiner),
                         ref_vars["params"], want, "refiner")


def test_dropout_masks():
    x = torch.ones(200_000)
    for rate in (0.3, 0.15):
        y = pspnet.dropout(x, rate, torch.Generator().manual_seed(3))
        zero = (y == 0).float().mean().item()
        sigma = (rate * (1 - rate) / x.numel()) ** 0.5
        assert abs(zero - rate) < 5 * sigma, (zero, rate)
        np.testing.assert_allclose(y[y != 0].numpy(), 1.0 / (1.0 - rate),
                                   rtol=1e-6)
        again = pspnet.dropout(x, rate, torch.Generator().manual_seed(3))
        assert torch.equal(y, again)
    assert pspnet.dropout(x, 0.0, None) is x


def test_posenet_train_mode():
    """Eval is the identity; train draws masks from the generator (same
    seed, same outputs); train without a generator raises."""
    torch.manual_seed(0)
    net = densefusion.PoseNet(NUM_OBJ)
    args = [t for k, t in dft.to_device(make_batch(4), "cpu").items()
            if k in ("img", "cloud", "choose", "obj_idx")]
    with torch.no_grad():
        plain = net(*args)
        again = net(*args, train=False)
        drop = [net(*args, train=True,
                    generator=torch.Generator().manual_seed(7))
                for _ in range(2)]
        net.cnn.dropout_rates = (0.0, 0.0, 0.0)
        off = net(*args, train=True,
                  generator=torch.Generator().manual_seed(7))
    for a, b, c, d in zip(plain, again, off, drop[0]):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert not torch.equal(plain[3], drop[0][3])
    for a, b in zip(*drop):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        net(*args, train=True)


def test_phase_transitions():
    cfg = dft.DFConfig(num_points=16, num_points_mesh=16)
    state = dft.create_trainer(num_obj=1, cfg=cfg, dtype=torch.float32,
                               device="cpu")
    state.best_test = 0.015  # < decay_margin but > refine_margin
    lr0 = state.lr
    state.maybe_transition(epoch=1)
    assert state.decay_start and not state.refine_start
    assert state.lr == pytest.approx(lr0 * cfg.lr_rate)
    assert state.w == pytest.approx(cfg.w * cfg.w_rate)
    assert state.optimizer.adam.param_groups[0]["lr"] == pytest.approx(
        state.lr)
    state.best_test = 0.009
    state.maybe_transition(epoch=2)
    assert state.refine_start
    assert state.refine_optimizer is not None
    assert state.refine_optimizer.adam.param_groups[0]["lr"] == \
        pytest.approx(state.lr)


def test_train_two_phases_writes_jax_checkpoints(setup, tmp_path):
    """train() through the estimator phase (epochs 1-2) and the refiner
    phase (epoch 3); the JAX package loads the written checkpoints, and its
    networks reproduce the port's outputs."""
    cfg = dft.DFConfig(batch_size=B, num_points=N, num_points_mesh=M,
                       refine_epoch_margin=2)
    state = dft.create_trainer(NUM_OBJ, cfg, dtype=torch.float32, seed=3,
                               device="cpu")
    train_set = [make_batch(10 + i) for i in range(2)]
    test_set = [make_batch(20)]
    seen, snapshots = [], {}

    def callback(st, epoch, test_dis):
        seen.append((epoch, st.refine_start))
        snapshots[epoch] = {k: v.clone()
                            for k, v in st.posenet.state_dict().items()}

    state = dft.train(state, lambda: iter(train_set), lambda: iter(test_set),
                      str(tmp_path), epochs=4, epoch_callback=callback)
    assert seen == [(1, False), (2, True), (3, True)]
    with open(tmp_path / "losses.json") as f:
        curves = json.load(f)["curves"]
    assert len(curves["test_dists"]) == 3
    assert np.isfinite(curves["losses"][:2]).all()
    assert curves["losses"][2] == 0.0           # refiner phase
    assert np.isfinite(curves["grad_norm_max"]).all()
    assert not torch.equal(snapshots[1]["head_t.conv4.weight"],
                           snapshots[2]["head_t.conv4.weight"])

    # the JAX package loads the best estimator checkpoint, and its PoseNet
    # there reproduces the port's network of that epoch
    batch = test_set[0]
    img, cloud, choose, obj = jax_args(batch)
    tensors = dft.to_device(batch, "cpu")
    out = jcheckpoints.load_checkpoint(str(tmp_path / "pose_model.npz"))
    epoch = out["meta"]["epoch"]
    assert epoch in (1, 2)
    want = jax.jit(setup["jpose"].apply)(out["variables"], img, cloud,
                                         choose, obj)
    net = densefusion.PoseNet(NUM_OBJ).eval()
    net.load_state_dict(snapshots[epoch])
    with torch.no_grad():
        got = net(tensors["img"], tensors["cloud"], tensors["choose"],
                  tensors["obj_idx"])
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=ATOL)
    # the port's own reader gives the same tree back
    mine = checkpoints.load_checkpoint(str(tmp_path / "pose_model"))
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            out["variables"])[0]:
        node = mine["variables"]
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf)


def test_checkpoint_roundtrip_jax_reads(setup, tmp_path):
    """save_checkpoint writes what the JAX reader takes with a `like`
    template, and the JAX PoseNet on it matches the port within 2e-4."""
    net = port_posenet(setup["pose_vars"])
    refiner = densefusion.PoseRefineNet(NUM_OBJ)
    refiner.load_state_dict(weights.refiner_state_dict(setup["ref_vars"]))
    checkpoints.save_checkpoint(str(tmp_path / "p" / "pose_model"),
                                weights.posenet_variables(net),
                                meta={"epoch": 7})
    checkpoints.save_checkpoint(str(tmp_path / "p" / "pose_refine_model"),
                                weights.refiner_variables(refiner))
    for name, like in (("pose_model", setup["pose_vars"]),
                       ("pose_refine_model", setup["ref_vars"])):
        out = jcheckpoints.load_checkpoint(str(tmp_path / "p" / name), like)
        for a, b in zip(jax.tree_util.tree_leaves(out["variables"]),
                        jax.tree_util.tree_leaves(like)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert os.path.exists(tmp_path / "p" / "pose_model.npz.meta.json")
    assert jcheckpoints.load_checkpoint(
        str(tmp_path / "p" / "pose_model"))["meta"] == {"epoch": 7}


def test_loader_and_curve_log(tmp_path):
    """The curve log writes the file the JAX dashboards read (the batch
    loader waits for the pose dataset that will call it)."""
    log = JsonCurveLog(str(tmp_path / "logs" / "c.json"), {"run": "a"})
    log.append(loss=np.float32(0.5))
    log.append(loss=0.25)
    with open(tmp_path / "logs" / "c.json") as f:
        assert json.load(f) == {"run": "a", "curves": {"loss": [0.5, 0.25]}}
