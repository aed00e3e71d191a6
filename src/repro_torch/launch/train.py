"""Training launcher of the port: ``--arch <id>`` on one device.

    python -m repro_torch.launch.train --arch olmo-1b --mpd-mode masked_dense --steps 4

builds the config (``--smoke`` for the reduced one), a random init from
``--seed`` on the CUDA device (``--device cpu`` runs on the CPU), a
``SyntheticLM`` stream from the same seed, and trains with the reference
launcher's optimizer: AdamW, clip 1.0, cosine schedule with
``min(20, steps // 5)`` warm-up steps. ``--mpd-mode masked_dense`` is the
paper-faithful mode (dense weights under a binary mask, re-applied after
every update); the config's own mode is ``packed``.

The deploy chain of the paper (train masked-dense, fold, serve)::

    python -m repro_torch.launch.train --arch olmo-1b --mpd-mode masked_dense \
        --mpd-fuse --steps 4 --fold-to-packed --quantize int8 --ckpt-dir DIR

``--mpd-fuse`` builds the masks aligned for the Fig-3 permutation fusion;
in the config's packed mode it trains the perm-fused model in the
parameterization it is served in, every FFN one ``fused_ffn`` launch
forward and bdmm launches backward (the fused_ffn autograd rule).
``--fold-to-packed`` folds the trained weights after the last step (with the
fusion rewrite under ``--mpd-fuse``, quantized with ``--quantize``) and
writes the packed artifact to ``DIR/packed``, which
``python -m repro_torch.launch.serve --paged --ckpt-dir DIR`` serves.

``--ckpt-dir DIR`` alone checkpoints params, optimizer state and the data
stream every 50 steps (written on a background thread) and resumes from
the newest one when run again. ``--compress-grads`` quantizes the
gradients to int8 with error feedback before the optimizer.
``--data-axis`` (a mesh's data-parallel size) is not ported: one device.
"""

from __future__ import annotations

import argparse

from repro_torch import device as device_lib
from repro_torch.configs.common import ARCHS, get_config
from repro_torch.data import SyntheticLM
from repro_torch.models import build
from repro_torch.optim import OptConfig
from repro_torch.train import TrainConfig, run


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", choices=ARCHS, required=True)
    p.add_argument("--smoke", action="store_true",
                   help="reduced same-family config (CPU-sized)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--global-batch", type=int, default=8)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--mpd-c", type=int, default=0, help="0 = config default")
    p.add_argument("--mpd-fuse", action="store_true",
                   help="Fig-3 aligned masks; in packed mode every FFN "
                   "trains as one fused_ffn launch forward")
    p.add_argument("--mpd-mode", choices=("", "packed", "masked_dense"),
                   default="", help="override the config's training "
                   "parameterization (masked_dense = paper-faithful)")
    p.add_argument("--fold-to-packed", action="store_true",
                   help="after training, fold the masked_dense weights into "
                   "a packed artifact (<ckpt-dir>/packed); with --mpd-fuse "
                   "the FFNs run the one-launch fused kernel when served")
    p.add_argument("--quantize", choices=("", "int8", "int4"), default="",
                   help="with --fold-to-packed: quantize the packed export "
                   "(int8 execution; int4 = nibble-packed storage)")
    p.add_argument("--ckpt-dir", default="",
                   help="train checkpoints every 50 steps and resume; "
                   "--fold-to-packed writes the artifact here too")
    p.add_argument("--compress-grads", action="store_true",
                   help="int8 gradient compression with error feedback")
    p.add_argument("--data-axis", type=int, default=0,
                   help="mesh data-axis size (not ported: only 0)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the init and of the data stream")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device; 'cpu' to "
                   "run on the host)")
    args = p.parse_args(argv)

    over = {}
    if args.mpd_c:
        over["mpd_c"] = args.mpd_c
    if args.mpd_fuse:
        over["mpd_fuse"] = True
    if args.mpd_mode:
        over["mpd_mode"] = args.mpd_mode
    if args.quantize and not args.fold_to_packed:
        raise SystemExit("--quantize quantizes the packed export; add "
                         "--fold-to-packed")
    if args.fold_to_packed:
        if not args.ckpt_dir:
            raise SystemExit("--fold-to-packed needs --ckpt-dir for the "
                             "packed export")
        if over.setdefault("mpd_mode", "masked_dense") != "masked_dense":
            raise SystemExit("--fold-to-packed folds a masked_dense run; "
                             "drop --mpd-mode packed")
    if args.data_axis:
        raise SystemExit("--data-axis: meshes and data parallelism are not "
                         "ported (ROADMAP A11); the port trains on one device")
    cfg = get_config(args.arch, smoke=args.smoke, **over)
    if cfg.frontend != "token":
        raise SystemExit(f"{args.arch} uses an embedding frontend; training "
                         "on embed inputs is not ported (ROADMAP queue A "
                         "item 5)")
    try:
        device = device_lib.resolve(args.device)
    except device_lib.NoCudaDevice as e:
        raise SystemExit(str(e)) from e
    model = build(cfg)
    print(f"{cfg.name}: {model.param_count():,} params")
    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq_len,
                       global_batch=args.global_batch, seed=args.seed)
    tcfg = TrainConfig(
        opt=OptConfig(lr=args.lr, clip_norm=1.0, schedule="cosine",
                      warmup_steps=min(20, args.steps // 5),
                      total_steps=args.steps),
        grad_compress_bits=8 if args.compress_grads else 0,
        ckpt_dir=args.ckpt_dir, ckpt_every=50 if args.ckpt_dir else 0)
    out = run(model, tcfg, data, num_steps=args.steps, seed=args.seed,
              device=device)
    if out["history"]:
        print(f"final loss {out['history'][-1]:.4f}")
    else:
        print(f"resumed at step {out['start_step']}: no step left to run")

    if args.fold_to_packed:
        import dataclasses

        from repro_torch.checkpoint import checkpoint as ckpt_lib
        d = ckpt_lib.export_packed(args.ckpt_dir, args.steps, model,
                                   out["params"], fuse=args.mpd_fuse,
                                   quantize=args.quantize or None)
        n_pk = build(dataclasses.replace(cfg, mpd_mode="packed")).param_count()
        print(f"packed export: {d} ({n_pk:,} params, was "
              f"{model.param_count():,}"
              + (f", {args.quantize}-quantized" if args.quantize else "")
              + ")")
    return out


if __name__ == "__main__":
    main()
