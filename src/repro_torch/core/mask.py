"""MPDCompress mask generation (copy of ``repro.core.mask``; numpy only).

For a dense layer ``y = x @ W`` with ``W ∈ R^{d_in × d_out}``: a
block-diagonal base ``B`` with ``nb`` blocks and a mask
``M[i, j] = B[p_in[i], p_out[j]]`` under random permutations. Masks are
deterministic functions of an integer seed — ``make_mask_spec`` draws from
``SeedSequence([seed, d_in, d_out, nb])`` exactly as the reference does, so
both packages build identical permutations.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from . import permute


@dataclasses.dataclass(frozen=True)
class MaskSpec:
    """Static description of one MPD mask (see ``repro.core.mask``).

    ``index_cache`` holds device copies of the gather indices, filled on
    first use by :mod:`repro_torch.core.fold`; it takes no part in equality.
    """

    d_in: int
    d_out: int
    nb: int
    in_perm: np.ndarray
    out_perm: np.ndarray
    seed: int = 0
    index_cache: dict = dataclasses.field(default_factory=dict, compare=False,
                                          repr=False)

    def __post_init__(self):
        assert self.in_perm.shape == (self.d_in,)
        assert self.out_perm.shape == (self.d_out,)

    @property
    def block_in(self) -> int:
        assert self.d_in % self.nb == 0, (self.d_in, self.nb)
        return self.d_in // self.nb

    @property
    def block_out(self) -> int:
        assert self.d_out % self.nb == 0, (self.d_out, self.nb)
        return self.d_out // self.nb

    @property
    def density(self) -> float:
        return 1.0 / self.nb

    @property
    def compression(self) -> float:
        return float(self.nb)

    @property
    def is_permuted(self) -> bool:
        return not (permute.is_identity(self.in_perm)
                    and permute.is_identity(self.out_perm))

    def nonzeros(self) -> int:
        return self.nb * self.block_in * self.block_out


def divisible(d_in: int, d_out: int, nb: int) -> bool:
    return d_in % nb == 0 and d_out % nb == 0


def make_mask_spec(
    d_in: int,
    d_out: int,
    nb: int,
    seed: int = 0,
    permuted: bool = True,
    in_perm: Optional[np.ndarray] = None,
    out_perm: Optional[np.ndarray] = None,
) -> MaskSpec:
    """Create a mask spec (Algorithm 1, procedure CREATING MASKS)."""
    if not divisible(d_in, d_out, nb):
        raise ValueError(f"nb={nb} must divide d_in={d_in} and d_out={d_out}")
    rng = np.random.default_rng(np.random.SeedSequence([seed, d_in, d_out, nb]))
    if in_perm is None:
        in_perm = (permute.random_permutation(rng, d_in) if permuted
                   else permute.identity(d_in))
    if out_perm is None:
        out_perm = (permute.random_permutation(rng, d_out) if permuted
                    else permute.identity(d_out))
    return MaskSpec(d_in=d_in, d_out=d_out, nb=nb,
                    in_perm=np.asarray(in_perm, np.int32),
                    out_perm=np.asarray(out_perm, np.int32), seed=seed)


def block_diag_base(d_in: int, d_out: int, nb: int, dtype=np.float32) -> np.ndarray:
    """The block-diagonal base matrix ``B`` (paper Fig 1e)."""
    b = np.zeros((d_in, d_out), dtype=dtype)
    bi, bo = d_in // nb, d_out // nb
    for n in range(nb):
        b[n * bi:(n + 1) * bi, n * bo:(n + 1) * bo] = 1
    return b


def mask_dense(spec: MaskSpec, dtype=np.float32) -> np.ndarray:
    """Materialize the binary mask ``M`` (paper Fig 1f)."""
    base = block_diag_base(spec.d_in, spec.d_out, spec.nb, dtype)
    return base[np.ix_(spec.in_perm, spec.out_perm)]


def block_id_of(spec: MaskSpec) -> Tuple[np.ndarray, np.ndarray]:
    """Block index owning each (unpermuted) input/output coordinate."""
    in_block = spec.in_perm // spec.block_in
    out_block = spec.out_perm // spec.block_out
    return in_block.astype(np.int32), out_block.astype(np.int32)


def chain_specs(dims: Tuple[int, ...], nb: int, seed: int = 0,
                fuse: bool = True) -> Tuple[MaskSpec, ...]:
    """Specs for a chain of FC layers ``dims[0] -> dims[1] -> ...``, drawn
    from ``SeedSequence([seed, len(dims), nb])`` as the reference draws them.
    With ``fuse=True`` layer ``i+1`` takes layer ``i``'s output permutation
    as its input permutation (paper Fig. 3), so the folded chain needs no
    gather between consecutive layers
    (:func:`repro_torch.core.fold.inter_layer_perm` is the identity)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, len(dims), nb]))
    specs = []
    prev_out: Optional[np.ndarray] = None
    for li in range(len(dims) - 1):
        in_perm = prev_out if fuse else None
        spec = make_mask_spec(dims[li], dims[li + 1], nb,
                              seed=int(rng.integers(2**31)), in_perm=in_perm)
        specs.append(spec)
        prev_out = spec.out_perm
    return tuple(specs)
