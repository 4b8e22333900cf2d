"""The port's classification modules against the JAX package on the same
inputs: ClassificationModel (unfused and BN-folded), the weight conversions
of the Classify head, the device augmentation's core on the JAX draws, the
host ImageFolder, the loss and one train step (f32, Adam, EMA)."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_port_helpers import random_state_dict, write_imagefolder
from yolov5_tpu_torch.data import classify as data_cls
from yolov5_tpu_torch.data.device_aug import (aug_generator, classify_augment_core,
                                              classify_aug_draws, classify_device_augment)
from yolov5_tpu_torch.models import weights as W
from yolov5_tpu_torch.models.yolo import ClassificationModel, build_model
from yolov5_tpu_torch.train import loss as loss_t
from yolov5_tpu_torch.train.optim import Optimizer
from yolov5_tpu_torch.train.run_classify import make_classify_step
from yolov5_tpu_torch.train.trainer import init_train_state

NC = 3


def _jax_model_and_weights(seed, cutoff=10):
    """A JAX ClassificationModel (yolov5n, NC classes) and a port model of the
    same random weights (non-trivial BN statistics)."""
    from yolov5_tpu.models import ClassificationModel as JaxCls
    from yolov5_tpu.models.weights import import_torch_weights

    port = ClassificationModel("yolov5n", nc=NC, cutoff=cutoff)
    sd = random_state_dict(port, np.random.default_rng(seed))
    jm = JaxCls("yolov5n", nc=NC, cutoff=cutoff)
    variables, missed = import_torch_weights(jm, sd)
    assert not missed
    return jm, variables, sd


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("fused", [False, True])
def test_classification_model_matches_jax(fused):
    """Logits of the port (unfused, or BN folded with the stem through
    stem_conv_plain) equal the JAX model's within 1e-4 of the largest."""
    from yolov5_tpu.train.run_classify import normalize as jax_normalize

    jm, variables, sd = _jax_model_and_weights(0)
    rng = np.random.default_rng(1)
    images = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    ref = np.asarray(jm.apply(variables, jax_normalize(jnp.asarray(images)), train=False))
    model = ClassificationModel("yolov5n", nc=NC, fused=fused)
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    assert not W.load_weights(model, W.fuse_conv_bn(tensors) if fused else tensors)
    assert model.model[0].stem == fused
    x = data_cls.normalize(torch.from_numpy(images).permute(0, 3, 1, 2))
    with torch.no_grad():
        got = model.eval()(x.contiguous(memory_format=torch.channels_last)).numpy()
    assert got.shape == (2, NC)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_classify_weights_round_trip():
    """from_jax_variables gives the torch layout (Dense kernel transposed to
    the Linear's (out, in)); to_jax_variables gives back the JAX tree."""
    jm, variables, sd = _jax_model_and_weights(2)
    got = W.from_jax_variables(variables)
    assert set(got) == set(sd) - {k for k in sd if k.endswith("num_batches_tracked")}
    assert tuple(got["model.10.linear.weight"].shape) == (NC, 1280)
    for k, v in sd.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    back = _flat(W.to_jax_variables(got))
    ref = _flat({"params": variables["params"], "batch_stats": variables["batch_stats"]})
    assert set(back) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k], err_msg=k)
    assert set(_flat(jm.variables)) == set(ref)


def test_fused_classifier_defaults_to_the_card():
    """Without ``device`` the BN-folded classifier goes to the card, so on a
    machine without one it raises rather than staying on the CPU; on the CPU
    when asked."""
    from yolov5_tpu_torch.train.run_classify import fused_classifier

    sd = ClassificationModel("yolov5n", nc=NC).state_dict()
    model = fused_classifier(sd, "yolov5n", NC, device="cpu")
    assert next(model.parameters()).device.type == "cpu" and not model.training
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fused_classifier(sd, "yolov5n", NC)


def test_classification_model_structure():
    """The JAX package's cut: layers 0-9 kept (SPPF included), Classify
    appended at 10; build_model routes the task."""
    m = build_model("yolov5n", task="classify", nc=NC)
    assert isinstance(m, ClassificationModel) and m.stride == (32,)
    assert [s.module for s in m.specs][-2:] == ["SPPF", "Classify"] and len(m.specs) == 11
    assert m.save == (4, 6)
    assert "model.10.conv.conv.weight" in m.state_dict()


def _jax_draws(key, b, scale=(0.08, 1.0), ratio=(0.75, 4.0 / 3.0), hflip=0.5, jitter=0.4):
    """The values yolov5_tpu's classify_device_augment draws from ``key``,
    in its split order."""
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    area = jax.random.uniform(k1, (b,), minval=scale[0], maxval=scale[1])
    logr = jax.random.uniform(k2, (b,), minval=jnp.log(ratio[0]), maxval=jnp.log(ratio[1]))
    off = jax.random.uniform(k3, (b, 2))
    flip = jax.random.uniform(k4, (b,)) < hflip
    jit = jax.random.uniform(k5, (3, b, 1, 1, 1), minval=1.0 - jitter, maxval=1.0 + jitter)
    t = lambda a: torch.from_numpy(np.array(a))
    return {"area": t(area), "logr": t(logr), "off": t(off), "flip": t(flip),
            "jitter": t(jit).reshape(3, b)}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_classify_augment_core_matches_jax(seed):
    """The deterministic core on the JAX function's own draws gives its
    images within one level."""
    from yolov5_tpu.data.device_aug import classify_device_augment as jax_aug

    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (6, 48, 48, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(jax_aug(jnp.asarray(images), key)).astype(int)
    got = classify_augment_core(torch.from_numpy(images), **_jax_draws(key, 6)).numpy()
    assert np.abs(got.astype(int) - ref).max() <= 1


def test_classify_augment_identity_crop_is_exact():
    images = np.random.default_rng(0).integers(0, 255, (4, 16, 16, 3), dtype=np.uint8)
    gen = aug_generator(0, 0, "cpu")
    out = classify_device_augment(torch.from_numpy(images), gen, scale=(1.0, 1.0),
                                  ratio=(1.0, 1.0), hflip=0.0, jitter=0.0)
    np.testing.assert_array_equal(out.numpy(), images)
    # a flip alone mirrors the width axis
    draws = classify_aug_draws(gen, 4, "cpu", scale=(1.0, 1.0), ratio=(1.0, 1.0), hflip=1.0,
                               jitter=0.0)
    out = classify_augment_core(torch.from_numpy(images), **draws)
    np.testing.assert_array_equal(out.numpy(), images[:, :, ::-1])


def test_classify_device_augment_draws_from_the_step():
    images = torch.from_numpy(np.random.default_rng(0).integers(0, 255, (4, 32, 32, 3),
                                                                dtype=np.uint8))
    a = classify_device_augment(images, aug_generator(0, 5, "cpu"))
    b = classify_device_augment(images, aug_generator(0, 5, "cpu"))
    c = classify_device_augment(images, aug_generator(0, 6, "cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c) and a.dtype == torch.uint8


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("cls")
    write_imagefolder(root, ["ants", "bees", "cats"], 4, ((40, 56), (64, 48), (50, 50), (33, 71)),
                      seed=3)
    return root


@pytest.mark.parametrize("augment", [False, True])
def test_image_folder_matches_jax(folder, augment):
    """Sample order, and every load (center crop, or the random crop and
    flip from one numpy Generator) bit for bit equal to the JAX class's,
    which reads and resizes with OpenCV."""
    from yolov5_tpu.train.run_classify import ImageFolder as JaxFolder

    ours, theirs = data_cls.ImageFolder(folder, 32, augment), JaxFolder(folder, 32, augment)
    assert ours.classes == theirs.classes and ours.samples == theirs.samples
    ra, rb = np.random.default_rng(5), np.random.default_rng(5)
    for i in range(len(ours)):
        (a, la), (b, lb) = ours.load(i, ra), theirs.load(i, rb)
        assert la == lb and a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)


def test_batches_and_cache_match_jax(folder):
    from yolov5_tpu.train.run_classify import ImageFolder as JaxFolder
    from yolov5_tpu.train.run_classify import build_cls_cache

    ours, theirs = data_cls.ImageFolder(folder, 32, True), JaxFolder(folder, 32, True)
    for epoch in (0, 1):
        a = list(ours.batches(5, shuffle=True, seed=2, epoch=epoch))
        b = list(theirs.batches(5, shuffle=True, seed=2, epoch=epoch))
        assert len(a) == len(b) == 2  # 12 images: the partial batch is dropped
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x["labels"], y["labels"])
            np.testing.assert_array_equal(x["images"], y["images"])
    for x, y in zip(data_cls.build_cls_cache(ours), build_cls_cache(theirs)):
        np.testing.assert_array_equal(x, y)


def test_normalize_matches_jax():
    from yolov5_tpu.train.run_classify import normalize as jax_normalize

    images = np.random.default_rng(0).integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    ref = np.asarray(jax_normalize(jnp.asarray(images)))
    got = data_cls.normalize(torch.from_numpy(images).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_classification_loss_matches_jax(smoothing):
    """Against the JAX classify step's loss (``run_classify.py``'s
    ``step_fn``): optax cross entropy on integer labels, or on
    optax.smooth_labels of the one-hot labels. (``yolov5_tpu.train.loss.
    classification_loss`` passes ``label_smoothing`` to an optax function
    that takes no such argument in optax 0.2.6, so it raises.)"""
    import optax

    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, (16, 7)).astype(np.float32)
    labels = rng.integers(0, 7, 16)
    if smoothing:
        sm = optax.smooth_labels(jax.nn.one_hot(labels, 7), smoothing)
        ref = float(optax.softmax_cross_entropy(jnp.asarray(logits), sm).mean())
    else:
        ref = float(optax.softmax_cross_entropy_with_integer_labels(
            jnp.asarray(logits), jnp.asarray(labels)).mean())
    got = float(loss_t.classification_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                           smoothing))
    assert got == pytest.approx(ref, abs=1e-6)


def opt_weight_keys(opt):
    return {opt.keys[i] for i in opt.groups["weight"]}


def test_train_step_matches_jax():
    """One f32 step (train-mode BN, label smoothing 0.1, Adam with the
    classify hyps, EMA) from equal weights: loss, accuracy and BN statistics
    within 1e-5, and the updated params and EMA within 1e-5 wherever the
    sign of the step is certain.

    Adam's first update is lr·g/(|g| + eps), about lr·sign(g), with g the
    clipped gradient plus weight decay. The packages' gradients differ by float
    rounding (flax takes the batch variance as E[x²] - E[x]², the port in two
    passes), so where |g| is within 100x of that difference the sign is a
    toss in either package: there the two updates are held to Adam's bound,
    at most opposite steps (2·lr apart), and such elements to under 1%."""
    import optax

    from yolov5_tpu.train.optim import build_optimizer, ema_init, ema_update
    from yolov5_tpu.train.run_classify import normalize as jax_normalize

    jm, variables, sd = _jax_model_and_weights(4)
    rng = np.random.default_rng(6)
    images = rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    labels = rng.integers(0, NC, 4).astype(np.int32)
    lr = 0.001
    hyp = {"lr0": lr, "lrf": 0.01, "momentum": 0.9, "weight_decay": 5e-5,
           "warmup_epochs": 0.0, "warmup_bias_lr": 0.0, "warmup_momentum": 0.9}
    params, stats = variables["params"], variables["batch_stats"]
    tx = build_optimizer(params, hyp, epochs=3, steps_per_epoch=2, batch_size=64, name="adam",
                         cos_lr=True)

    @jax.jit
    def jax_step(params):
        def loss_of(p):
            logits, mutated = jm.module.apply({"params": p, "batch_stats": stats},
                                              jax_normalize(jnp.asarray(images)), train=True,
                                              mutable=["batch_stats"])
            sm = optax.smooth_labels(jax.nn.one_hot(labels, NC), 0.1)
            return optax.softmax_cross_entropy(logits.astype(jnp.float32), sm).mean(), (
                mutated["batch_stats"], (logits.argmax(-1) == labels).mean())

        (loss, (new_stats, acc)), grads = jax.value_and_grad(loss_of, has_aux=True)(params)
        updates, _ = tx.update(grads, tx.init(params), params)
        new = optax.apply_updates(params, updates)
        return loss, acc, grads, new, new_stats

    jloss, jacc, grads, jparams, jstats = jax_step(params)
    jema = jax.jit(ema_update)(ema_init(params, stats), jparams, jstats)

    model = ClassificationModel("yolov5n", nc=NC)
    assert not W.load_weights(model, {k: torch.from_numpy(v) for k, v in sd.items()})
    model = model.to(memory_format=torch.channels_last)
    twin = copy.deepcopy(model).train()
    x = data_cls.normalize(torch.from_numpy(images).permute(0, 3, 1, 2))
    own_grads = dict(zip([k for k, _ in twin.named_parameters()], torch.autograd.grad(
        loss_t.classification_loss(twin(x.contiguous(memory_format=torch.channels_last)),
                                   torch.from_numpy(labels), 0.1), list(twin.parameters()))))
    opt = Optimizer(dict(model.named_parameters()), hyp, epochs=3, steps_per_epoch=2,
                    batch_size=64, name="adam", cos_lr=True)
    state = init_train_state(model, opt)
    step = make_classify_step(label_smoothing=0.1)
    state, m = step(state, {"images": torch.from_numpy(images),
                            "labels": torch.from_numpy(labels)})
    assert float(m["loss"]) == pytest.approx(float(jloss), abs=1e-5)
    assert float(m["acc"]) == pytest.approx(float(jacc), abs=1e-9)

    ref_grads = W.from_jax_variables({"params": grads})
    norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in ref_grads.values()]))
    clip = min(1.0, opt.clip_norm / float(norm))  # the step clips before it decays
    clear = {}
    for k, g in ref_grads.items():
        decayed = clip * g + (opt.decay * torch.from_numpy(sd[k]) if k in opt_weight_keys(opt)
                              else 0)
        clear[k] = (decayed.abs() > 100 * clip * (own_grads[k] - g).abs()).numpy()
    tossed = sum(int((~c).sum()) for c in clear.values())
    assert tossed < 0.01 * sum(c.size for c in clear.values()), tossed

    def check(got, ref):
        assert set(got) == set(ref)
        for k, v in got.items():
            d = np.abs(v.detach().numpy() - ref[k].numpy())
            mask = clear.get(k, np.ones(d.shape, bool))
            assert d[mask].max(initial=0) <= 1e-5, (k, d[mask].max())
            assert d[~mask].max(initial=0) <= 2 * lr * (1 + 1e-5), (k, d[~mask].max())

    check({**dict(model.named_parameters()),
           **{k: v for k, v in model.named_buffers() if not k.endswith("num_batches_tracked")}},
          W.from_jax_variables({"params": jparams, "batch_stats": jstats}))
    check({**state.ema.params, **state.ema.batch_stats},
          W.from_jax_variables({"params": jema.params, "batch_stats": jema.batch_stats}))
