"""Paper-figure reproductions on LeNet-300-100 with the PyTorch/CUDA port
(the counterpart of ``benchmarks/paper_repro.py``, with the same rows).

    python benchmarks/torch_paper_repro.py [--fast] [--sections table1,fig4,fig5]
    PYTHONPATH=src python -m benchmarks.torch_paper_repro --fast --device cpu

The ``TeacherStudent`` generator stands in for MNIST (an exactly-learnable
800 -> 10 classification task), so what is reproduced is the paper's
*relative* claims:

  * Table 1: MPD at c = 10 keeps accuracy within ~1 point of dense, with
    ~10x fewer FC parameters.
  * Fig 4a:  accuracy is insensitive to WHICH random mask is drawn.
  * Fig 4a (ablation): non-permuted block-diagonal masks lose points.
  * Fig 4b:  summed masks cover the matrix uniformly.
  * Fig 5:   the sweep over c in {4, 8, 16}. The policy's divisibility
    fallback realises c = 8 as 5 blocks a layer and c = 16 as the c = 10
    plan; the rows keep the reference's "density = 100/c" label.

Training follows the paper's §3.1 recipe, as the reference does: batch 50,
AdamW at lr 1e-3 (the port's ``optim.apply_updates``), the masks
re-applied after every update in masked-dense mode. Packed layers run the
port's bdmm kernel, masked-dense layers the masked matmul and its SDDMM,
on the card; on the CPU (``--device cpu``) every kernel takes its plain
version. Without ``--device`` the run needs a CUDA device. Prints
``name,value,derived`` rows, then the device it ran on.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import device as device_lib  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs.lenet300 import LeNet300  # noqa: E402
from repro_torch.core.mask import make_mask_spec, mask_dense  # noqa: E402
from repro_torch.core.policy import DENSE, CompressionPolicy, uniform  # noqa: E402
from repro_torch.data import TeacherStudent  # noqa: E402
from repro_torch.optim import OptConfig, apply_updates, init_state  # noqa: E402

SECTIONS = ("table1", "fig4", "fig5")


def to_device(batch: Dict[str, np.ndarray], dev) -> Dict[str, torch.Tensor]:
    return {"inputs": torch.from_numpy(batch["inputs"]).to(dev),
            "labels": torch.from_numpy(batch["labels"]).to(dev, torch.long)}


def make_step(model: LeNet300, ocfg: OptConfig):
    """The train step ``(params, opt_state, batch) -> (params, opt_state,
    loss)``: the loss's gradient through autograd, one optimizer update,
    then (masked-dense) the masks re-applied."""
    mask_fn = model.reapply_masks if model.mode == "masked_dense" else None

    def step(params, ostate, batch):
        live = [p.detach().requires_grad_(True)
                for p in tree_lib.leaves(params)]
        loss = model.loss(tree_lib.unflatten(params, live), batch)
        grads = tree_lib.unflatten(params, torch.autograd.grad(loss, live))
        with torch.no_grad():
            params, ostate, _ = apply_updates(ocfg, params, grads, ostate,
                                              mask_fn=mask_fn)
        return params, ostate, loss.detach()

    return step


def train_lenet(policy: CompressionPolicy, mode: str = "packed",
                steps: int = 400, seed: int = 0, data_seed: int = 0,
                lr: float = 1e-3, device=None,
                params: Optional[Any] = None) -> Dict[str, Any]:
    """Train one LeNet-300-100 (paper §3.1 recipe: batch 50, lr 1e-3) from
    ``model.init(seed)``, or from ``params`` (e.g. carried over from the
    reference). Returns the eval accuracy on 2048 held-out samples, the FC
    parameter count, the seconds taken, the last loss and the params."""
    dev = device_lib.resolve(device)
    model = LeNet300(policy=policy, mode=mode)
    data = TeacherStudent(d_in=800, n_classes=10, batch=50, seed=data_seed)
    if params is None:
        params = model.init(seed, device=dev)
    ocfg = OptConfig(kind="adamw", lr=lr)
    ostate = init_state(ocfg, params)
    step = make_step(model, ocfg)

    t0 = time.time()
    for _ in range(steps):
        params, ostate, loss = step(params, ostate,
                                    to_device(data.next(), dev))
    with torch.no_grad():
        acc = float(model.accuracy(params, to_device(data.eval_set(2048),
                                                     dev)))
    return {"accuracy": acc, "fc_params": model.fc_param_count(),
            "train_s": time.time() - t0, "final_loss": float(loss),
            "params": params}


def table1(steps: int = 400, device=None) -> List[str]:
    """Table 1 analogue: dense vs MPD 10x accuracy + param counts."""
    dense = train_lenet(DENSE, steps=steps, device=device)
    mpd = train_lenet(uniform(10, min_block=1), steps=steps, device=device)
    return [
        f"table1_dense_acc,{dense['accuracy']*100:.2f},fc_params={dense['fc_params']}",
        f"table1_mpd10x_acc,{mpd['accuracy']*100:.2f},fc_params={mpd['fc_params']}",
        f"table1_acc_delta_pts,{(dense['accuracy']-mpd['accuracy'])*100:.2f},"
        f"compression={dense['fc_params']/mpd['fc_params']:.1f}x",
    ]


def fig4b_rows() -> List[str]:
    """Fig 4b: the sum of 100 masks drawn at c = 10 covers a 300 x 100
    matrix uniformly."""
    total = np.zeros((300, 100), np.float32)
    for i in range(100):
        total += mask_dense(make_mask_spec(300, 100, 10, seed=i))
    return [f"fig4b_mask_sum_mean,{total.mean():.2f},expected=10.0",
            f"fig4b_mask_sum_std,{total.std():.2f},"
            f"uniform_binomial_std={np.sqrt(100*0.1*0.9):.2f}"]


def fig4_masks(n_masks: int = 8, steps: int = 300, device=None) -> List[str]:
    """Fig 4a/b: robustness over random mask draws + mask-sum uniformity."""
    accs = np.array([train_lenet(uniform(10, min_block=1, seed=i),
                                 steps=steps, device=device)["accuracy"]
                     for i in range(n_masks)])
    return [
        f"fig4a_masks_acc_mean,{accs.mean()*100:.2f},n={n_masks}",
        f"fig4a_masks_acc_min,{accs.min()*100:.2f},"
        f"spread={100*(accs.max()-accs.min()):.2f}pts",
    ] + fig4b_rows()


def fig4_permutation_ablation(steps: int = 300, device=None) -> List[str]:
    """§3.1: permuted vs non-permuted block-diagonal masks at 10% density."""
    perm = train_lenet(uniform(10, min_block=1, permuted=True), steps=steps,
                       device=device)
    noperm = train_lenet(uniform(10, min_block=1, permuted=False),
                         steps=steps, device=device)
    return [
        f"fig4_permuted_acc,{perm['accuracy']*100:.2f},density=10%",
        f"fig4_nonpermuted_acc,{noperm['accuracy']*100:.2f},density=10%",
        f"fig4_permutation_gain_pts,{(perm['accuracy']-noperm['accuracy'])*100:.2f},paper=+17.1",
    ]


def fig5_sparsity(steps: int = 300, device=None) -> List[str]:
    """Fig 5: accuracy across compression factors (the paper's 4/8/16x)."""
    dense = train_lenet(DENSE, steps=steps, device=device)
    rows = [f"fig5_dense_acc,{dense['accuracy']*100:.2f},c=1"]
    for c in (4, 8, 16):
        r = train_lenet(uniform(c, min_block=1), steps=steps, device=device)
        rows.append(
            f"fig5_c{c}_acc,{r['accuracy']*100:.2f},"
            f"density={100.0/c:.2f}%,delta={(dense['accuracy']-r['accuracy'])*100:+.2f}pts")
    return rows


def device_line(dev: torch.device) -> str:
    if dev.type != "cuda":
        return f"device,{dev.type}"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    return f"device,{torch.cuda.get_device_name(dev)},{smi}"


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true",
                    help="150 steps and 4 masks (the reference's --fast)")
    ap.add_argument("--sections", default=",".join(SECTIONS),
                    help=f"comma-separated subset of {','.join(SECTIONS)}")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs every kernel's plain version on the "
                         "host; the default is the CUDA device")
    args = ap.parse_args(argv)
    want = set(args.sections.split(","))
    if not want <= set(SECTIONS):
        ap.error(f"--sections: unknown {sorted(want - set(SECTIONS))}")
    try:
        dev = device_lib.resolve(args.device)
    except device_lib.NoCudaDevice as e:
        raise SystemExit(f"torch_paper_repro: {e}")
    steps = 150 if args.fast else 400
    n_masks = 4 if args.fast else 8

    rows: List[str] = []
    if "table1" in want:
        rows += table1(steps=steps, device=dev)
    if "fig4" in want:
        rows += fig4_masks(n_masks=n_masks, steps=max(steps // 2, 100),
                           device=dev)
        rows += fig4_permutation_ablation(steps=steps, device=dev)
    if "fig5" in want:
        rows += fig5_sparsity(steps=max(steps // 2, 100), device=dev)
    for r in rows:
        print(r)
    print(device_line(dev))
    return 0


if __name__ == "__main__":
    sys.exit(main())
