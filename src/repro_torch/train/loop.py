"""Training loop (the port of ``repro.train.loop`` for one device): the
step (loss, grads, optimizer update, mask projection), set-up and the
step loop ``run`` with step-time monitoring.

Not ported here: meshes and sharding, gradient compression, microbatching
and checkpointing. Params stay plain tensors; each step attaches autograd
to detached views of them, so no param holds a graph between steps.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.dist.straggler import StragglerMonitor
from repro_torch.optim import optimizer as opt_lib


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: opt_lib.OptConfig = opt_lib.OptConfig()
    log_every: int = 10


def make_train_step(model, tcfg: TrainConfig) -> Callable:
    """The train step ``(params, opt_state, batch) -> (params, opt_state,
    metrics)``; masked-dense models with ``mpd_c > 1`` re-apply their masks
    after every update."""
    masked = model.cfg.mpd_mode == "masked_dense" and model.cfg.mpd_c > 1
    mask_fn = model.mask_projection if masked else None

    def step(params, opt_state, batch):
        live = [p.detach().requires_grad_(True)
                for p in tree_lib.leaves(params)]
        loss = model.train_loss(tree_lib.unflatten(params, live), batch)
        grads = torch.autograd.grad(loss, live)
        with torch.no_grad():
            params, opt_state, metrics = opt_lib.apply_updates(
                tcfg.opt, params, tree_lib.unflatten(params, grads),
                opt_state, mask_fn=mask_fn)
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    return step


def setup(model, tcfg: TrainConfig, *, seed: int = 0, params=None,
          device=None) -> Tuple[Any, Any, Callable]:
    """``(params, opt_state, step_fn)``: params from ``model.init(seed)`` on
    ``device`` (the CUDA device unless ``"cpu"``), or the ``params`` given."""
    if params is None:
        params = model.init(seed, device=device)
    return (params, opt_lib.init_state(tcfg.opt, params),
            make_train_step(model, tcfg))


def run(model, tcfg: TrainConfig, data_iter, num_steps: int, *,
        seed: int = 0, params=None, device=None,
        log_fn=print) -> Dict[str, Any]:
    """Train for ``num_steps``. Returns the final ``params`` and
    ``opt_state``, the per-step loss ``history`` and the per-step seconds
    ``step_s`` (host clock around the step, ended by reading the loss,
    which waits for the whole step on the device)."""
    params, opt_state, step_fn = setup(model, tcfg, seed=seed, params=params,
                                       device=device)
    dev = next(tree_lib.leaves(params)).device
    monitor = StragglerMonitor()
    history, step_s = [], []
    for i in range(num_steps):
        batch = {k: torch.from_numpy(v).to(dev, torch.long)
                 for k, v in data_iter.next().items()}
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        step_s.append(time.perf_counter() - t0)
        monitor.observe(step_s[-1])
        history.append(loss)
        if tcfg.log_every and (i % tcfg.log_every == 0 or i == num_steps - 1):
            log_fn(f"step {i:6d} loss {loss:.4f} "
                   f"lr {metrics['lr']:.2e} "
                   f"t {monitor.mean_step_time * 1e3:.1f}ms")
    return {"params": params, "opt_state": opt_state, "history": history,
            "step_s": step_s}
