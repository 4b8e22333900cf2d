"""Optimizer, LR and momentum schedules, and the EMA of the weights.

The port of ``yolov5_tpu/train/optim.py`` (the reference's
utils/torch_utils.py:257-375 and train.py:234-251). The JAX package builds
an optax chain; ``Optimizer.step`` is that chain written out in torch, step
for step:
  1. ``clip_by_global_norm(10)`` over all gradients;
  2. weight decay added to the weight group only, scaled
     ``weight_decay * batch_size * accumulate / nbs``;
  3. per group (weight: conv kernels; bn: BN scales; bias: every bias),
     nesterov SGD with the lr and momentum of the real-update count, or Adam,
     or AdamW (decay decoupled, on the weight group);
  4. frozen layers' updates zeroed after all of it;
  5. ``optax.MultiSteps``: micro-batch gradients are AVERAGED (Welford, as
     optax's ``use_grad_mean=True``; the reference sums them) over
     ``accumulate`` batches, the count ramping 1 -> nbs/bs over warmup.
The counters (micro-step, real updates) are host integers: a step never
waits for the device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


def one_cycle(y1=0.0, y2=1.0, steps=100):
    """Cosine ramp y1 -> y2 over ``steps``."""
    return lambda x: ((1 - math.cos(x * math.pi / steps)) / 2) * (y2 - y1) + y1


def lr_lambda(epochs, lrf, cos_lr=False):
    if cos_lr:
        return one_cycle(1.0, lrf, epochs)
    return lambda e: max(1 - e / epochs, 0.0) * (1.0 - lrf) + lrf


def make_schedules(hyp, epochs, steps_per_epoch, batch_size, nbs=64, cos_lr=False,
                   accumulate=1):
    """Per-update lr (weights, bias) and momentum schedules with warmup, as
    functions of the real-update count; and the warmup length nw in real
    updates (the reference's max(3 epochs, 100 batches), train.py:338,
    converted to real updates; 0 when warmup_epochs is 0)."""
    lr0 = hyp.get("lr0", 0.01)
    lrf = hyp.get("lrf", 0.01)
    warmup_epochs = hyp.get("warmup_epochs", 3.0)
    warmup_bias_lr = hyp.get("warmup_bias_lr", 0.1)
    warmup_momentum = hyp.get("warmup_momentum", 0.8)
    momentum = hyp.get("momentum", 0.937)
    steps_per_epoch = max(round(steps_per_epoch / accumulate), 1)  # real updates
    if warmup_epochs > 0:
        nw = max(round(warmup_epochs * steps_per_epoch), round(100 / accumulate))
    else:
        nw = 0
    lam = lr_lambda(epochs, lrf, cos_lr)

    def ramp(step):
        return min(max(step / max(nw, 1), 0.0), 1.0)

    def lr_weights(step):
        lr = lr0 * lam(step / steps_per_epoch)
        return ramp(step) * lr if step < nw else lr

    def lr_bias(step):
        lr = lr0 * lam(step / steps_per_epoch)
        return warmup_bias_lr + ramp(step) * (lr - warmup_bias_lr) if step < nw else lr

    def mom(step):
        if step < nw:
            return warmup_momentum + ramp(step) * (momentum - warmup_momentum)
        return momentum

    return lr_weights, lr_bias, mom, nw


def group_of(key: str) -> str:
    """'bias' | 'bn' | 'weight' for a state_dict key (the JAX package's
    ``_group_of`` on the matching flax path): every bias, then the scale of
    every BN (a module named ``bn`` or ``*_bn``), then the rest (conv and
    Linear weights, AconC's p1, p2 and beta)."""
    if key.endswith(".bias"):
        return "bias"
    parts = key.split(".")
    if parts[-1] == "weight" and len(parts) > 1 and (parts[-2] == "bn"
                                                    or parts[-2].endswith("_bn")):
        return "bn"
    return "weight"


def freeze_mask(keys, freeze):
    """The set of keys to freeze. ``freeze`` is N (the first N graph layers)
    or a list of layer indices or key prefixes (reference train.py:216-222)."""
    if isinstance(freeze, int):
        freeze = range(freeze)
    prefixes = tuple(f"model.{f}." if isinstance(f, int) else str(f) for f in freeze)
    return {k for k in keys if k.startswith(prefixes)}


def accumulate_ramp(accumulate, nw_updates):
    """Micro-batches per real update at a real-update count: 1 -> accumulate
    over warmup."""
    def k(gradient_step):
        frac = gradient_step / max(nw_updates, 1)
        return int(min(max(np.round(1 + (accumulate - 1) * frac), 1), accumulate))
    return k


def _bias_correction(beta, count):
    """1 - beta**count in float32, as optax computes it: with beta2 = 0.999
    the float64 value differs in the fifth digit."""
    return (1 - torch.tensor(beta, dtype=torch.float32) ** count).item()


class Optimizer:
    """The 3-group optimizer of ``yolov5_tpu.train.optim.build_optimizer``
    over ``params`` ({state_dict key: parameter}). ``step(grads)`` takes one
    micro-batch's gradients (in the order of ``params``) and returns True
    when it made a real update."""

    def __init__(self, params: dict, hyp, epochs, steps_per_epoch, batch_size, name="sgd",
                 nbs=64, cos_lr=False, clip_norm=10.0, freeze=None):
        self.name = name.lower()
        if self.name not in ("sgd", "adam", "adamw"):
            raise ValueError(f"optimizer {name!r}: sgd, adam or adamw")
        self.keys = list(params)
        self.params = [params[k] for k in self.keys]
        self.accumulate = max(round(nbs / batch_size), 1)
        self.lr_w, self.lr_b, self.mom, self.nw = make_schedules(
            hyp, epochs, steps_per_epoch, batch_size, nbs, cos_lr,
            accumulate=self.accumulate)
        self.k_steps = accumulate_ramp(self.accumulate, self.nw)
        self.decay = hyp.get("weight_decay", 5e-4) * batch_size * self.accumulate / nbs
        self.beta1 = hyp.get("momentum", 0.937)
        self.clip_norm = clip_norm
        frozen = freeze_mask(self.keys, freeze) if freeze else set()
        self.groups = {g: [i for i, k in enumerate(self.keys) if group_of(k) == g]
                       for g in ("weight", "bn", "bias")}
        self.frozen = {i for i, k in enumerate(self.keys) if k in frozen}
        self.mini_step = 0
        self.gradient_step = 0  # real updates so far
        zeros = lambda: [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.acc = zeros() if self.accumulate > 1 else None
        self.buffers = ({"trace": zeros()} if self.name == "sgd"
                        else {"mu": zeros(), "nu": zeros()})

    def step(self, grads) -> bool:
        grads = [g.float() for g in grads]
        if self.acc is not None:
            k = self.k_steps(self.gradient_step)
            n = self.mini_step
            diff = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(diff, float(n + 1))
            torch._foreach_add_(self.acc, diff)  # the running mean of the micro-batches
            if n < k - 1:
                self.mini_step += 1
                return False
            grads, self.acc = self.acc, [torch.zeros_like(a) for a in self.acc]
            self.mini_step = 0
        self._update(grads)
        self.gradient_step += 1
        return True

    @torch.no_grad()
    def _update(self, grads):
        c = self.gradient_step
        if self.clip_norm:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            scale = torch.where(norm < self.clip_norm, 1.0, self.clip_norm / norm)
            grads = torch._foreach_mul(grads, scale)
        else:
            grads = [g.clone() for g in grads]  # the caller's gradients stay as they are
        lrs = {"weight": self.lr_w(c), "bn": self.lr_w(c), "bias": self.lr_b(c)}
        for group, idx in self.groups.items():
            if not idx:
                continue
            g = [grads[i] for i in idx]
            p = [self.params[i] for i in idx]
            wd = self.decay if group == "weight" else 0.0
            if wd and self.name != "adamw":
                torch._foreach_add_(g, p, alpha=wd)
            if self.name == "sgd":
                m = self.mom(c)
                trace = [self.buffers["trace"][i] for i in idx]
                torch._foreach_mul_(trace, m)
                torch._foreach_add_(trace, g)  # trace = g + m * trace
                torch._foreach_add_(g, trace, alpha=m)  # nesterov: g + m * trace
            else:
                b1, b2, eps = self.beta1, 0.999, 1e-8
                mu = [self.buffers["mu"][i] for i in idx]
                nu = [self.buffers["nu"][i] for i in idx]
                torch._foreach_mul_(mu, b1)
                torch._foreach_add_(mu, g, alpha=1 - b1)
                torch._foreach_mul_(nu, b2)
                torch._foreach_addcmul_(nu, g, g, 1 - b2)
                mu_hat = torch._foreach_div(mu, _bias_correction(b1, c + 1))
                nu_hat = torch._foreach_div(nu, _bias_correction(b2, c + 1))
                denom = torch._foreach_sqrt(nu_hat)
                torch._foreach_add_(denom, eps)
                g = torch._foreach_div(mu_hat, denom)
                if wd and self.name == "adamw":  # decoupled decay
                    torch._foreach_add_(g, p, alpha=wd)
            for j, i in enumerate(idx):
                if i in self.frozen:  # frozen: the update is zeroed, the buffers kept
                    g[j] = torch.zeros_like(g[j])
            torch._foreach_add_(p, g, alpha=-lrs[group])

    def state_dict(self) -> dict:
        """Counters as ints, buffers as {name: {key: tensor}}."""
        out = {"name": self.name, "mini_step": self.mini_step,
               "gradient_step": self.gradient_step}
        for name, bufs in self.buffers.items():
            out[name] = dict(zip(self.keys, bufs))
        if self.acc is not None:
            out["acc_grads"] = dict(zip(self.keys, self.acc))
        return out

    def load_state_dict(self, state: dict) -> None:
        if state.get("name") != self.name:
            raise ValueError(f"optimizer state of {state.get('name')!r}, not {self.name!r}")
        self.mini_step = int(state["mini_step"])
        self.gradient_step = int(state["gradient_step"])
        lists = dict(self.buffers, **({"acc_grads": self.acc} if self.acc is not None else {}))
        for name, bufs in lists.items():
            for k, buf in zip(self.keys, bufs):
                buf.copy_(torch.tensor(np.asarray(state[name][k])))


class EMAState(NamedTuple):
    params: dict  # {key: f32 tensor}
    batch_stats: dict
    updates: int


def ema_init(params: dict, batch_stats: dict) -> EMAState:
    copy = lambda t: {k: v.detach().float().clone() for k, v in t.items()}
    return EMAState(copy(params), copy(batch_stats), 0)


@torch.no_grad()
def ema_update(state: EMAState, params: dict, batch_stats: dict, decay=0.9999, tau=2000.0,
               tick=True) -> EMAState:
    """d = decay * (1 - exp(-updates / tau)); ema = d * ema + (1 - d) * new,
    in float32 as the JAX package computes it. ``tick`` False (a micro-batch
    that made no real update) leaves the EMA as it is."""
    if not tick:
        return state
    updates = state.updates + 1
    f32 = np.float32
    d = f32(decay) * (f32(1.0) - np.exp(-f32(updates) / f32(tau)))
    for ema, new in ((state.params, params), (state.batch_stats, batch_stats)):
        e = list(ema.values())
        torch._foreach_mul_(e, float(d))
        torch._foreach_add_(e, [new[k].detach().float() for k in ema], alpha=float(f32(1.0) - d))
    return EMAState(state.params, state.batch_stats, updates)
