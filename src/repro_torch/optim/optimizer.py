"""Optimizers written out by hand (the port of ``repro.optim.optimizer``):
AdamW and SGD with momentum, LR schedules, global-norm clipping and the MPD
mask re-application hook. ``torch.optim`` is not used: its AdamW keeps its
moments in f32 and orders its arithmetic differently.

As in the reference, every update is computed in f32 and stored back in the
param dtype, the moments included (bf16 moments for a bf16 model), and the
paper's post-update mask projection (Algorithm 1 line 14) runs as
``mask_fn`` after the update. Functional: new tensors are returned and the
inputs are left as they were. The step count stays on the host, and the
schedule is evaluated there in f32, so a step issues no device sync.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import tree as tree_lib


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"          # adamw | sgd
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    momentum: float = 0.9        # sgd
    clip_norm: float = 0.0       # 0 => off
    # schedule
    schedule: str = "constant"   # constant | cosine | step
    warmup_steps: int = 0
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    step_decay_every: int = 0    # paper's AlexNet recipe: /10 every 30 epochs
    step_decay_rate: float = 0.1


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def schedule_lr(cfg: OptConfig, step: int) -> float:
    """The learning rate at ``step``, computed in f32 as the reference's
    jnp arithmetic is; warm-up is ``min(1, (step + 1) / warmup_steps)``."""
    s = _f32(step)
    lr = _f32(cfg.lr)
    warm = (torch.clamp((s + 1) / cfg.warmup_steps, max=1.0)
            if cfg.warmup_steps else 1.0)
    if cfg.schedule == "cosine":
        frac = torch.clamp((s - cfg.warmup_steps)
                           / max(cfg.total_steps - cfg.warmup_steps, 1),
                           0.0, 1.0)
        decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
            1 + torch.cos(_f32(math.pi) * frac))
    elif cfg.schedule == "step" and cfg.step_decay_every:
        decay = _f32(cfg.step_decay_rate) ** torch.floor(
            s / cfg.step_decay_every)
    else:
        decay = 1.0
    return float(lr * warm * decay)


def init_state(cfg: OptConfig, params) -> Dict[str, Any]:
    """``{"step": 0, "mu", "nu"}`` (AdamW) or ``{"step": 0, "mom"}`` (SGD),
    moments as zeros in each param's dtype and device."""
    zeros = lambda: tree_lib.map_leaves(torch.zeros_like, params)
    if cfg.kind == "adamw":
        return {"step": 0, "mu": zeros(), "nu": zeros()}
    if cfg.kind == "sgd":
        return {"step": 0, "mom": zeros()}
    raise ValueError(cfg.kind)


def clip_by_global_norm(grads, max_norm: float):
    """Scale every gradient by ``min(1, max_norm / (|g| + 1e-9))``, the norm
    taken over all leaves in f32. Returns ``(grads, norm)``; the norm stays
    a device tensor."""
    leaves = list(tree_lib.leaves(grads))
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return (tree_lib.map_leaves(lambda g: (g.float() * scale).to(g.dtype),
                                grads), gn)


def apply_updates(cfg: OptConfig, params, grads, state,
                  mask_fn: Optional[Callable] = None):
    """One optimizer step. Returns ``(new_params, new_state, metrics)``.

    ``mask_fn(params) -> params`` is the paper's post-update mask
    projection; ``None`` for packed and dense models."""
    metrics: Dict[str, Any] = {}
    if cfg.clip_norm:
        grads, gn = clip_by_global_norm(grads, cfg.clip_norm)
        metrics["grad_norm"] = gn
    lr = schedule_lr(cfg, state["step"])
    metrics["lr"] = lr

    if cfg.kind == "adamw":
        t = _f32(state["step"]) + 1.0
        bc1 = float(1 - cfg.b1 ** t)
        bc2 = float(1 - cfg.b2 ** t)

        def upd(p, g, mu, nu):
            g32 = g.float()
            mu = cfg.b1 * mu.float() + (1 - cfg.b1) * g32
            nu = cfg.b2 * nu.float() + (1 - cfg.b2) * g32 * g32
            step = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
            if cfg.weight_decay:
                step = step + cfg.weight_decay * p.float()
            return ((p.float() - lr * step).to(p.dtype), mu.to(p.dtype),
                    nu.to(p.dtype))

        out = list(map(upd, *(list(tree_lib.leaves(t)) for t in
                              (params, grads, state["mu"], state["nu"]))))
        new_p = tree_lib.unflatten(params, (o[0] for o in out))
        new_state = {"step": state["step"] + 1,
                     "mu": tree_lib.unflatten(params, (o[1] for o in out)),
                     "nu": tree_lib.unflatten(params, (o[2] for o in out))}
    elif cfg.kind == "sgd":
        def upd(p, g, m):
            m = cfg.momentum * m.float() + g.float()
            return (p.float() - lr * m).to(p.dtype), m.to(p.dtype)

        out = list(map(upd, *(list(tree_lib.leaves(t)) for t in
                              (params, grads, state["mom"]))))
        new_p = tree_lib.unflatten(params, (o[0] for o in out))
        new_state = {"step": state["step"] + 1,
                     "mom": tree_lib.unflatten(params, (o[1] for o in out))}
    else:
        raise ValueError(cfg.kind)

    if mask_fn is not None:
        new_p = mask_fn(new_p)
    return new_p, new_state, metrics
