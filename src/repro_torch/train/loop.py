"""Training loop (the port of ``repro.train.loop`` for one device): the
step (loss, grads over optional microbatches, optional int8 gradient
compression with error feedback, optimizer update, mask projection),
set-up with auto-resume from the newest checkpoint, and the step loop
``run`` with step-time monitoring, periodic and emergency checkpoints
written on a background thread.

Not ported here: meshes and sharding. Params stay plain tensors; each step
attaches autograd to detached views of them, so no param holds a graph
between steps.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.dist import compress as compress_lib
from repro_torch.dist.microbatch import (microbatched_value_and_grad,
                                         value_and_grad)
from repro_torch.dist.straggler import StragglerMonitor
from repro_torch.optim import optimizer as opt_lib


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: opt_lib.OptConfig = opt_lib.OptConfig()
    grad_compress_bits: int = 0       # 0 = off; 8 = int8 EF compression
    microbatch: int = 0               # rows a microbatch; 0 = no accumulation
    ckpt_dir: str = ""
    ckpt_every: int = 0
    log_every: int = 10


def make_train_step(model, tcfg: TrainConfig) -> Callable:
    """The train step ``(params, opt_state, ef_state, batch) -> (params,
    opt_state, ef_state, metrics)``; ``ef_state`` is the compression's
    residual tree (``{}`` without compression). Masked-dense models with
    ``mpd_c > 1`` re-apply their masks after every update."""
    masked = model.cfg.mpd_mode == "masked_dense" and model.cfg.mpd_c > 1
    mask_fn = model.mask_projection if masked else None
    bits = tcfg.grad_compress_bits

    def step(params, opt_state, ef_state, batch):
        B = batch["labels"].shape[0]
        if tcfg.microbatch and B > tcfg.microbatch:
            mb = tcfg.microbatch
            n = B // mb
            if B % mb:      # drop the remainder rows, as the reference does
                batch = {k: v[:n * mb] for k, v in batch.items()}
            loss, grads = microbatched_value_and_grad(model.train_loss,
                                                      params, batch, n)
        else:
            loss, grads = value_and_grad(model.train_loss, params, batch)
        with torch.no_grad():
            if bits > 0:
                grads, ef_state = compress_lib.compress_with_ef(
                    grads, ef_state, bits)
            params, opt_state, metrics = opt_lib.apply_updates(
                tcfg.opt, params, grads, opt_state, mask_fn=mask_fn)
        metrics["loss"] = loss
        return params, opt_state, ef_state, metrics

    return step


def setup(model, tcfg: TrainConfig, *, seed: int = 0, params=None,
          device=None) -> Tuple[Any, Any, Any, Callable, int]:
    """``(params, opt_state, ef_state, step_fn, start_step)``. With a
    checkpoint under ``tcfg.ckpt_dir`` the params and optimizer state are
    restored from its newest step onto ``device`` (or the device of the
    ``params`` given) and that step is ``start_step``; otherwise params
    come from ``model.init(seed)`` on ``device`` (the CUDA device unless
    ``"cpu"``), or are the ``params`` given, and ``start_step`` is 0."""
    last = ckpt_lib.latest_step(tcfg.ckpt_dir) if tcfg.ckpt_dir else None
    if last is not None:
        if params is not None:
            device = next(tree_lib.leaves(params)).device
        # restore into a shape template: no init is materialised first
        like_p = (model.init(seed, device="meta") if params is None
                  else params)
        state = ckpt_lib.restore(
            tcfg.ckpt_dir, last,
            {"params": like_p, "opt": opt_lib.init_state(tcfg.opt, like_p)},
            device=device)
        params, opt_state = state["params"], state["opt"]
    else:
        if params is None:
            params = model.init(seed, device=device)
        opt_state = opt_lib.init_state(tcfg.opt, params)
    ef_state = (compress_lib.init_ef_state(params)
                if tcfg.grad_compress_bits > 0 else {})
    return (params, opt_state, ef_state, make_train_step(model, tcfg),
            last or 0)


def run(model, tcfg: TrainConfig, data_iter, num_steps: int, *,
        seed: int = 0, params=None, device=None,
        log_fn=print) -> Dict[str, Any]:
    """Train up to step ``num_steps``, resuming (params, optimizer state
    and the data stream) from the newest checkpoint under
    ``tcfg.ckpt_dir``. Every ``ckpt_every`` steps, and when the straggler
    monitor asks for one, ``{"params", "opt"}`` is saved with the data
    stream's state, written on a background thread; every write has ended
    when this returns.

    Returns the final ``params`` and ``opt_state``, ``start_step``, the
    loss ``history`` and the seconds ``step_s`` of the steps run (host
    clock around the step, ended by reading the loss, which waits for the
    whole step on the device), the seconds the loop spent in ``save``
    (``ckpt_save_s``: the host snapshot) and waiting for the writes at the
    end (``ckpt_wait_s``)."""
    params, opt_state, ef_state, step_fn, start = setup(
        model, tcfg, seed=seed, params=params, device=device)
    if start:
        data_iter.restore(ckpt_lib.load_extra(tcfg.ckpt_dir, start).get(
            "data", data_iter.state()))
    dev = next(tree_lib.leaves(params)).device
    monitor = StragglerMonitor()
    history, step_s, save_s = [], [], 0.0
    for i in range(start, num_steps):
        batch = {k: torch.from_numpy(v).to(dev, torch.long)
                 for k, v in data_iter.next().items()}
        t0 = time.perf_counter()
        params, opt_state, ef_state, metrics = step_fn(
            params, opt_state, ef_state, batch)
        loss = float(metrics["loss"])
        step_s.append(time.perf_counter() - t0)
        verdict = monitor.observe(step_s[-1])
        history.append(loss)
        if tcfg.log_every and (i % tcfg.log_every == 0 or i == num_steps - 1):
            log_fn(f"step {i:6d} loss {loss:.4f} "
                   f"lr {metrics['lr']:.2e} "
                   f"t {monitor.mean_step_time * 1e3:.1f}ms")
        do_ckpt = tcfg.ckpt_dir and tcfg.ckpt_every and (
            (i + 1) % tcfg.ckpt_every == 0)
        if verdict == "checkpoint" and tcfg.ckpt_dir:
            do_ckpt = True      # emergency snapshot on a persistent straggle
        if do_ckpt:
            t0 = time.perf_counter()
            ckpt_lib.save(tcfg.ckpt_dir, i + 1,
                          {"params": params, "opt": opt_state},
                          extra={"data": data_iter.state()}, blocking=False)
            save_s += time.perf_counter() - t0
    t0 = time.perf_counter()
    ckpt_lib.wait_pending()
    return {"params": params, "opt_state": opt_state, "start_step": start,
            "history": history, "step_s": step_s, "ckpt_save_s": save_s,
            "ckpt_wait_s": time.perf_counter() - t0}
