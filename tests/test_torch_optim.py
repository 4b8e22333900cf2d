"""The port's optimizer, schedules and EMA against the JAX package's optax
chain (yolov5_tpu.train.optim.build_optimizer) on the same parameters and
gradients, drawn with numpy from a seed.

Tolerances: schedules within 1e-6 relative (f32 against float64
arithmetic); parameters after every step within 1e-6 (absolute, plus 1e-6
relative: a few f32 ulps), for SGD, Adam and AdamW, warmup,
the accumulation ramp (the mean of the micro-batches), clipping and freeze;
EMA within 1e-6."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from yolov5_tpu.train import optim as jax_optim
from yolov5_tpu.utils.hyp import SCRATCH_LOW
from yolov5_tpu_torch.models.weights import (from_jax_variables, to_jax_variables,
                                             torch_key_to_flax)
from yolov5_tpu_torch.train import optim

SHAPES = {
    "model.0.conv.weight": (8, 3, 3, 3), "model.0.bn.weight": (8,), "model.0.bn.bias": (8,),
    "model.1.cv1.conv.weight": (4, 8, 1, 1), "model.1.cv1.bn.weight": (4,),
    "model.1.cv1.bn.bias": (4,), "model.2.m.0.weight": (12, 4, 1, 1), "model.2.m.0.bias": (12,),
}


def _params(rng):
    return {k: rng.normal(0, 0.5, s).astype(np.float32) for k, s in SHAPES.items()}


CASES = {
    "sgd_warmup": dict(name="sgd", batch_size=64),
    "sgd_accumulate_ramp": dict(name="sgd", batch_size=16, hyp={"warmup_epochs": 0.0}),
    "sgd_cos_lr": dict(name="sgd", batch_size=64, cos_lr=True, hyp={"warmup_epochs": 0.0}),
    "sgd_freeze": dict(name="sgd", batch_size=64, freeze=1),
    "adam": dict(name="adam", batch_size=64),
    "adamw_accumulate": dict(name="adamw", batch_size=32, hyp={"warmup_epochs": 0.0}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_optimizer_matches_optax(rng, case):
    kw = dict(CASES[case])
    hyp = {**SCRATCH_LOW, "lr0": 0.05, **kw.pop("hyp", {})}
    steps = 10 if kw["batch_size"] < 64 else 5
    sched = dict(epochs=3, steps_per_epoch=4)
    p0 = _params(rng)
    jparams = to_jax_variables(p0)["params"]
    tx = jax_optim.build_optimizer(jparams, hyp, **sched, **kw)
    opt_state = tx.init(jparams)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    opt = optim.Optimizer(tparams, hyp, **sched, **kw)
    clipped = 0
    for i in range(steps):
        scale = 2.0 if i % 2 else 0.1  # every other step crosses the clip norm of 10
        grads = {k: rng.normal(0, scale, s).astype(np.float32) for k, s in SHAPES.items()}
        clipped += np.sqrt(sum((g ** 2).sum() for g in grads.values())) > 10
        updates, opt_state = tx.update(to_jax_variables(grads)["params"], opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        emitted = opt.step([torch.from_numpy(grads[k]) for k in opt.keys])
        got = {k: v.numpy() for k, v in tparams.items()}
        ref = {k: v.numpy() for k, v in from_jax_variables({"params": jparams}).items()}
        for k in SHAPES:
            np.testing.assert_allclose(got[k], ref[k], atol=1e-6, rtol=1e-6,
                                       err_msg=f"step {i} {k}")
        if hasattr(opt_state, "gradient_step"):
            assert opt.gradient_step == int(opt_state.gradient_step)
            assert emitted == (int(opt_state.mini_step) == 0)
    assert clipped >= 2
    if kw.get("freeze"):
        for k in ("model.0.conv.weight", "model.0.bn.weight", "model.0.bn.bias"):
            np.testing.assert_array_equal(tparams[k].numpy(), p0[k])
    if kw["batch_size"] < 64:
        assert opt.accumulate == 64 // kw["batch_size"] and 1 <= opt.gradient_step < steps


def test_accumulation_averages_micro_batches(rng):
    """Under accumulation the real update is the one of the MEAN of the
    micro-batch gradients (optax MultiSteps' default), not of their sum."""
    hyp = {**SCRATCH_LOW, "warmup_epochs": 0.0}
    p0 = _params(rng)
    grads = [{k: rng.normal(0, 0.05, s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(5)]

    def run(batch_size, feed):
        params = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
        # 4 real updates per epoch either way, so that the lr schedules agree
        opt = optim.Optimizer(params, hyp, 3, 4 * 64 // batch_size, batch_size)
        for g in feed:
            opt.step([torch.from_numpy(g[k]) for k in opt.keys])
        return params

    # accumulate 4: update 1 takes grads[0] alone (the ramp starts at 1),
    # update 2 the mean of grads[1:5]
    acc = run(16, grads)
    mean = {k: np.mean([g[k] for g in grads[1:]], 0) for k in SHAPES}
    ref = run(64, [grads[0], mean])  # no accumulation, same decay
    ref_opt = optim.Optimizer({k: torch.zeros(s) for k, s in SHAPES.items()}, hyp, 3, 4, 16)
    assert ref_opt.decay == optim.Optimizer({k: torch.zeros(s) for k, s in SHAPES.items()},
                                            hyp, 3, 4, 64).decay
    for k in SHAPES:
        np.testing.assert_allclose(acc[k].numpy(), ref[k].numpy(), atol=1e-6, err_msg=k)


@pytest.mark.parametrize("cos_lr", [False, True])
@pytest.mark.parametrize("accumulate", [1, 4])
def test_schedules_match_jax(cos_lr, accumulate):
    hyp = dict(SCRATCH_LOW)
    args = (hyp, 10, 37, 64 // accumulate)
    kw = dict(nbs=64, cos_lr=cos_lr, accumulate=accumulate)
    ref = jax_optim.make_schedules(*args, **kw)
    got = optim.make_schedules(*args, **kw)
    assert got[3] == ref[3]
    ramp_ref = jax_optim._accumulate_ramp(accumulate, ref[3])
    ramp = optim.accumulate_ramp(accumulate, got[3])
    for step in list(range(0, 120, 7)) + [ref[3] - 1, ref[3], 500]:
        for g, r in zip(got[:3], ref[:3]):
            np.testing.assert_allclose(g(step), float(r(jnp.asarray(step))), rtol=1e-6,
                                       atol=1e-7)
        assert ramp(step) == int(ramp_ref(jnp.asarray(step)))


def _leaves(tree, path=()):
    """{flax path tuple: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, path + (k,)) if isinstance(v, dict) else {path + (k,): v})
    return out


def test_groups_and_freeze_match_jax(rng):
    jtree = to_jax_variables(_params(rng))["params"]
    labels = _leaves(jax_optim.group_labels(jtree))
    frozen_ref = _leaves(jax_optim.freeze_mask(jtree, 2))
    frozen = optim.freeze_mask(list(SHAPES), 2)
    for k in SHAPES:
        path = tuple(torch_key_to_flax(k)[1])
        assert optim.group_of(k) == labels[path], k
        assert (k in frozen) == bool(frozen_ref[path]), k


def test_ema_matches_jax(rng):
    """ema_update over ticks and non-ticks against the JAX EMAState."""
    params = {k: rng.normal(0, 1, s).astype(np.float32) for k, s in SHAPES.items()}
    stats = {"model.0.bn.running_mean": rng.normal(0, 1, 8).astype(np.float32),
             "model.0.bn.running_var": rng.uniform(0.5, 2, 8).astype(np.float32)}
    ema = optim.ema_init({k: torch.from_numpy(v) for k, v in params.items()},
                         {k: torch.from_numpy(v) for k, v in stats.items()})
    jv = to_jax_variables({**params, **stats})
    jema = jax_optim.ema_init(jv["params"], jv["batch_stats"])
    for i, tick in enumerate([True, True, False, True, False, True]):
        params = {k: v + rng.normal(0, 0.1, v.shape).astype(np.float32)
                  for k, v in params.items()}
        stats = {k: v * 1.01 for k, v in stats.items()}
        jv = to_jax_variables({**params, **stats})
        jema = jax_optim.ema_update(jema, jv["params"], jv["batch_stats"],
                                    decay=0.9, tau=2.0, tick=jnp.asarray(tick))
        ema = optim.ema_update(ema, {k: torch.from_numpy(v) for k, v in params.items()},
                               {k: torch.from_numpy(v) for k, v in stats.items()},
                               decay=0.9, tau=2.0, tick=tick)
        assert ema.updates == int(jema.updates)
        ref = from_jax_variables({"params": jema.params, "batch_stats": jema.batch_stats})
        for k, v in {**ema.params, **ema.batch_stats}.items():
            np.testing.assert_allclose(v.numpy(), ref[k].numpy(), atol=1e-6, err_msg=f"{i} {k}")
