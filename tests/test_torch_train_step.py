"""One train step of the port against yolov5_tpu.train.trainer on the same
weights and batch (yolov5n, 128 px, b2, float32): the loss, every
parameter's gradient, the parameters after the update and the BN running
statistics (moved with the BIASED batch variance, as flax does); then a
10-step trajectory, with and without gradient accumulation.

Tolerances: loss within 1e-5 relative; gradients within 3e-3 of each
tensor's largest entry (the two packages' f32 convolutions sum in other
orders: the train-mode head maps already differ by 6e-5 relative, and the
backward through 24 layers of batch norm on 4x4 to 64x64 maps brings the
early layers' gradients to 1.1e-3); parameters, BN statistics and EMA
after one step within 5e-5 of each tensor's largest entry (the bias group
steps at the warmup lr of 0.1); the 10-step trajectory: every loss within
1e-4 relative, the final parameters and EMA within 1e-3 of each tensor's
largest entry (ten updates of the gradients above)."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import random_state_dict, yolov5n_cfg
from yolov5_tpu.models import DetectionModel as JaxModel
from yolov5_tpu.models.weights import import_torch_weights
from yolov5_tpu.train import loss as jax_loss
from yolov5_tpu.train import optim as jax_optim
from yolov5_tpu.train import trainer as jax_trainer
from yolov5_tpu.utils.hyp import SCRATCH_LOW
from yolov5_tpu_torch.models.layers import batch_norm_train
from yolov5_tpu_torch.models.weights import from_jax_variables
from yolov5_tpu_torch.models.yolo import DetectionModel
from yolov5_tpu_torch.train import loss, optim, trainer

CFG = yolov5n_cfg(3)
IMGSZ, BS = 128, 2


def _batch(rng, m=6):
    images = rng.integers(0, 256, (BS, IMGSZ, IMGSZ, 3), dtype=np.uint8)
    t = np.zeros((BS, m, 5), np.float32)
    v = np.zeros((BS, m), bool)
    for b in range(BS):
        n = 3 + b
        t[b, :n, 0] = rng.integers(0, 3, n)
        t[b, :n, 1:3] = rng.uniform(0.15, 0.85, (n, 2))
        t[b, :n, 3:5] = rng.uniform(0.05, 0.5, (n, 2))
        v[b, :n] = True
    return {"images": images, "targets": t, "valid": v}


def _pair(seed, nbs, warmup_epochs=3.0):
    """The same weights, loss and optimizer in both packages."""
    rng = np.random.default_rng(seed)
    port = DetectionModel(CFG)
    sd = random_state_dict(port, rng)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=False)
    jm = JaxModel(CFG, packed_stem=False)
    jm.variables, missed = import_torch_weights(jm, sd)
    assert not missed
    hyp = trainer.scale_hyp({**SCRATCH_LOW, "warmup_epochs": warmup_epochs}, nl=3, nc=3,
                            imgsz=IMGSZ)
    sched = dict(epochs=3, steps_per_epoch=5, batch_size=BS, nbs=nbs)
    tx = jax_optim.build_optimizer(jm.params, hyp, **sched)
    jstate = jax_trainer.init_train_state(jm, tx)
    jstep = jax_trainer.make_train_step(jm, jax_loss.ComputeLoss(jm.anchors_per_stride, 3, hyp),
                                        tx)
    opt = optim.Optimizer(dict(port.named_parameters()), hyp, **sched)
    state = trainer.init_train_state(port, opt)
    aps = port.anchors_per_stride
    assert aps == jm.anchors_per_stride
    step = trainer.make_train_step(loss.ComputeLoss(aps, 3, hyp), dtype=torch.float32)
    return (jm, jstate, jstep), (state, step), hyp, aps, rng


def _sd(variables):
    return {k: v.numpy() for k, v in from_jax_variables(variables).items()}


def _close(got: dict, ref: dict, rtol, what, scale_atol=True):
    for k, r in ref.items():
        g = got[k]
        atol = rtol * np.abs(r).max() if scale_atol else rtol
        np.testing.assert_allclose(g, r, rtol=rtol, atol=atol, err_msg=f"{what} {k}")


def test_one_step_loss_grads_params_and_bn_stats():
    (jm, jstate, jstep), (state, step), hyp, aps, rng = _pair(0, nbs=BS)
    batch = _batch(rng)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    # gradients: a separate forward/backward of each package on the batch
    import jax

    jloss = jax_loss.ComputeLoss(jm.anchors_per_stride, 3, hyp)

    def loss_of(params):
        out, _ = jm.module.apply({"params": params, "batch_stats": jstate.batch_stats},
                                 jnp.asarray(batch["images"]).astype(jnp.float32) / 255.0,
                                 train=True, mutable=["batch_stats"])
        return jloss(out, jnp.asarray(batch["targets"]), jnp.asarray(batch["valid"]))[0]

    ref_total, ref_grads = jax.value_and_grad(loss_of)(jstate.params)
    twin = copy.deepcopy(state.model).train()
    x = tb["images"].permute(0, 3, 1, 2).float() / 255.0
    total, _ = loss.ComputeLoss(aps, 3, hyp)(twin(x.contiguous(memory_format=torch.channels_last)),
                                             tb["targets"], tb["valid"])
    total.backward()
    np.testing.assert_allclose(total.item(), float(ref_total), rtol=1e-5)
    _close({k: p.grad.numpy() for k, p in twin.named_parameters()},
           _sd({"params": ref_grads}), 3e-3, "grad")

    # the step itself: parameters, BN statistics, EMA
    jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state, metrics = step(state, tb)
    np.testing.assert_allclose(metrics["total"].item(), float(jmetrics["total"]), rtol=1e-5)
    np.testing.assert_allclose(metrics["grad_norm"].item(), float(jmetrics["grad_norm"]),
                               rtol=1e-4)
    got = {k: v.detach().numpy() for k, v in state.model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    ref = _sd({"params": jstate.params, "batch_stats": jstate.batch_stats})
    _close(got, ref, 5e-5, "after one step")
    assert state.ema.updates == int(jstate.ema.updates) == 1
    _close({k: v.numpy() for k, v in {**state.ema.params, **state.ema.batch_stats}.items()},
           _sd({"params": jstate.ema.params, "batch_stats": jstate.ema.batch_stats}),
           5e-5, "ema")


def test_bn_moves_running_var_with_the_biased_variance():
    """flax's BatchNorm (the JAX package) moves running_var toward the
    biased batch variance; torch's BatchNorm2d toward the unbiased one. On a
    4x4 map of batch 2 (n = 32) the two differ by 1/31."""
    torch.manual_seed(0)
    x = torch.randn(2, 8, 4, 4) * 3 + 1
    bn = torch.nn.BatchNorm2d(8, eps=1e-3, momentum=0.03)
    ref = torch.nn.BatchNorm2d(8, eps=1e-3, momentum=0.03)
    y = batch_norm_train(x, bn)
    y_ref = ref.train()(x)
    torch.testing.assert_close(y, y_ref, atol=1e-5, rtol=1e-5)  # same normalization
    var_b = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.97 + 0.03 * var_b)
    torch.testing.assert_close(bn.running_mean, 0.03 * x.mean(dim=(0, 2, 3)))
    assert not torch.allclose(bn.running_var, ref.running_var, rtol=1e-3)


@pytest.mark.parametrize("nbs", [BS, 2 * BS])
def test_ten_step_trajectory_matches_jax(nbs):
    """10 steps on fresh batches; with nbs = 2 * bs (and no warmup, so that
    the ramp is short) the optimizer averages two micro-batches per real
    update after the first, and the EMA ticks only on real updates."""
    (jm, jstate, jstep), (state, step), _, _, rng = _pair(1, nbs=nbs,
                                                          warmup_epochs=3.0 if nbs == BS else 0.0)
    for i in range(10):
        batch = _batch(rng)
        jstate, jm_ = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        for k in ("total", "box", "obj", "cls"):
            np.testing.assert_allclose(m[k].item(), float(jm_[k]), rtol=1e-4,
                                       err_msg=f"step {i} {k}")
    assert state.step == int(jstate.step) == 10
    assert state.ema.updates == int(jstate.ema.updates)
    if nbs > BS:
        assert state.opt.gradient_step == int(jstate.opt_state.gradient_step) < 10
    got = {k: v.detach().numpy() for k, v in state.model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    _close(got, _sd({"params": jstate.params, "batch_stats": jstate.batch_stats}), 1e-3,
           "after 10 steps")
    _close({k: v.numpy() for k, v in {**state.ema.params, **state.ema.batch_stats}.items()},
           _sd({"params": jstate.ema.params, "batch_stats": jstate.ema.batch_stats}),
           1e-3, "ema after 10 steps")
