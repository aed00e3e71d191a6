"""LeNet-300-100, the paper's own §3.1 model, as an MLP classifier stack
(the port of ``repro.configs.lenet300``).

Not part of the LM zoo; used by the paper-figure benchmarks (Table 1,
Fig 4, Fig 5, the §3.3 speedup) with the ``TeacherStudent`` data stand-in.
Built directly from MPD linear layers (800-300-100-10: 784 padded to 800 so
that c = 10 divides every layer). Every layer goes through
:func:`repro_torch.core.mpd.apply`: packed layers run ``ops.bdmm``,
masked-dense layers ``ops.masked_matmul``, dense layers ``x @ w``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Tuple

import torch

from repro_torch import device as device_lib
from repro_torch.core import mpd
from repro_torch.core.policy import DENSE, CompressionPolicy

Params = List[Dict[str, Any]]


@dataclasses.dataclass(frozen=True)
class LeNet300:
    d_in: int = 800
    h1: int = 300
    h2: int = 100
    n_classes: int = 10
    policy: CompressionPolicy = DENSE
    mode: str = "packed"

    @functools.cached_property
    def specs(self) -> Tuple[mpd.MPDLinearSpec, ...]:
        """The three layers' specs (mask seed salts 1, 2, 3), resolved once
        per model so that each mask's device tensors and gather indices are
        built once."""
        pol = self.policy
        dims = [(self.d_in, self.h1, "mlp", 1), (self.h1, self.h2, "mlp", 2),
                (self.h2, self.n_classes, "head", 3)]
        specs = []
        for d_in, d_out, kind, salt in dims:
            mask = pol.plan(d_in, d_out, kind, seed_salt=salt)
            mode = self.mode if mask is not None else "dense"
            specs.append(mpd.MPDLinearSpec(d_in, d_out, mask, mode=mode))
        return tuple(specs)

    def init(self, seed: int = 0, device=None) -> Params:
        """Random init from ``seed`` on ``device`` (the CUDA device unless
        ``device="cpu"``). Draws differ from ``jax.random``; parity tests
        carry the reference's params over with :mod:`repro_torch.convert`.
        ``device="meta"`` builds the shape template only."""
        dev = device_lib.resolve(device)
        gen = (None if dev.type == "meta"
               else torch.Generator(device=dev).manual_seed(seed))
        return [mpd.init(gen, s, device=dev) for s in self.specs]

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        s = self.specs
        h = torch.relu(mpd.apply(s[0], params[0], x))
        h = torch.relu(mpd.apply(s[1], params[1], h))
        return mpd.apply(s[2], params[2], h)

    def loss(self, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Mean cross-entropy, taken in f32 through logsumexp."""
        lg = self.apply(params, batch["inputs"]).float()
        lse = torch.logsumexp(lg, dim=-1)
        ll = torch.gather(lg, -1, batch["labels"].long()[:, None])[:, 0]
        return torch.mean(lse - ll)

    def accuracy(self, params: Params,
                 batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        lg = self.apply(params, batch["inputs"])
        return torch.mean((torch.argmax(lg, -1) == batch["labels"].long())
                          .float())

    def fc_param_count(self) -> int:
        return sum(s.param_count() for s in self.specs)

    def reapply_masks(self, params: Params) -> Params:
        return [mpd.reapply_mask(s, p) for s, p in zip(self.specs, params)]
