"""Zero-knowledge DEEP-ALI STARK prover on torch tensors.

The base path of `toyni_tpu.prover.StarkProver`: the default `StarkConfig`
(one-column Fibonacci AIR, salted SHA-256 trees, base-field challenges),
with the same phases, the same random draws in the same order, and so the
same proof bytes for the same seed.

  commit   trace INTT, mask T + Z_H * R, coset shift, LDE NTT at N; salted
           leaf hashing and tree levels; the constraint on rolled eval
           vectors, the quotient through the 1/Z_H tile; a second tree
  OOD      one batched inverse of (x_i - z), barycentric sums
  DEEP     the four quotients over the shared (x_i - z)^-1
  FRI      fold, square the inverse points, commit each layer (the final
           layer unsalted)
  queries  value gathers, sibling paths and the opened leaves' salts

The NTTs and SHA-256 run as CUDA kernels for tensors on the card and as
their plain torch versions for tensors on the CPU. The transcript, the OOD
sanity check and proof assembly are host code.

Not ported yet, and refused with NotImplementedError: extension-field
challenges, Poseidon2 trees, other AIRs, and LDE sizes from 2^22 up (where
the JAX package prunes its trees).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .air import FibonacciAir, require_ported
from .config import DEFAULT_CONFIG, StarkConfig
from .domain import Domain, _shift_tables
from .field import babybear as bb
from .field.babybear import P, I64
from .merkle import (
    LEAFLESS_MIN,
    DeviceTree,
    build_salted_device_tree,
    build_unsalted_device_tree,
    extract_paths,
    openings_from_paths,
)
from .ops import ntt as ntt_ops
from .ops import salts as salts_mod
from .ops.fri import fri_fold
from .proof import MerkleOpening, QueryProof, StarkProof
from .trace import ExecutionTrace
from .transcript import Transcript, derive_z


@functools.lru_cache(maxsize=8)
def phase_tables(n: int, N: int, shift: int, device: str) -> dict:
    """The proof's constant tables for trace length n, in standard form on
    `device` (int64, the twiddles int32):

      trace_intt  packed NTT twiddles for size n and omega_n^-1
      fft         packed NTT twiddles for size N and omega_N
      shift_fwd   shift^i, i < N
      zh_tile     1 / Z_H(x_i) over the shifted LDE domain
      x           x_i = shift * omega_N^i
      xs_inv      x_i^-1
    """
    om_n = bb.get_root_of_unity(n.bit_length() - 1)
    om_N = bb.get_root_of_unity(N.bit_length() - 1)
    B = N // n
    # Z_H(x_i) = x_i^n - 1 depends on i mod B only: shift^n * omega_N^(n i) - 1
    h_n = pow(shift, n, P)
    zh = [(pow(om_N, n * i, P) * h_n - 1) % P for i in range(B)]
    zh_inv = torch.tensor([pow(v, P - 2, P) for v in zh], dtype=I64)
    return dict(
        trace_intt=ntt_ops.twiddle_table(n, pow(om_n, P - 2, P), device),
        fft=ntt_ops.twiddle_table(N, om_N, device),
        shift_fwd=_shift_tables(N, shift, device)[0],
        zh_tile=zh_inv.to(device).repeat(n),
        x=Domain.new(N).get_coset(shift).elements(device),
        xs_inv=bb.powers(pow(om_N, P - 2, P), N, device=device)
        * pow(shift, P - 2, P) % P,
    )


def lde_input(t_coeffs: torch.Tensor, r_mask: torch.Tensor,
              shift_fwd: torch.Tensor) -> torch.Tensor:
    """The LDE NTT's input: the masked trace polynomial T + Z_H * R
    (Z_H = x^n - 1, so R enters shifted up by n and negated at 0), its
    coefficients zero-padded to N and multiplied by shift^i."""
    n, m, N = t_coeffs.shape[0], r_mask.shape[0], shift_fwd.shape[0]
    L = n + m
    that = torch.zeros(N, dtype=I64, device=t_coeffs.device)
    that[:n] = t_coeffs
    r_low = torch.zeros(L, dtype=I64, device=t_coeffs.device)
    r_low[:m] = r_mask
    that[n:L] = r_mask
    that[:L] = bb.sub(that[:L], r_low)
    return bb.mul(that, shift_fwd)


class StarkProver:
    def __init__(
        self,
        trace: ExecutionTrace,
        air: FibonacciAir | None = None,
        config: StarkConfig = DEFAULT_CONFIG,
        seed: int | None = None,
        device: str | torch.device = "cuda",
    ):
        self.trace = trace
        self.air = air or FibonacciAir()
        self.config = config
        self.device = torch.device(device)
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"no prover for device {self.device}")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("StarkProver(device='cuda'): no CUDA device found")
        require_ported(self.air, config)
        # numpy's generator, drawn in the JAX prover's order: mask, trace
        # salts, quotient salts, then one key per salted FRI layer
        self.rng = np.random.default_rng(seed)

    def _layer_key(self) -> tuple:
        """The Threefry key of one salted layer (one rng draw)."""
        return salts_mod.key_words(int(self.rng.integers(0, 2**63)))

    def _salted_tree(self, values: torch.Tensor, key: tuple) -> DeviceTree:
        salts = salts_mod.salts_full(key, values.shape[0], values.device)
        return build_salted_device_tree(values, salts)

    # ── phases ────────────────────────────────────────────────────────────

    def _commit(self, tabs, trace_col, r_mask, trace_key, quot_key, n):
        """Interpolate, mask, coset LDE, constraint, quotient, two trees."""
        cfg = self.config
        t_coeffs = bb.mul(
            ntt_ops.apply_ntt(trace_col, tabs["trace_intt"]), pow(n, P - 2, P)
        )
        trace_lde = ntt_ops.apply_ntt(
            lde_input(t_coeffs, r_mask, tabs["shift_fwd"]), tabs["fft"]
        )
        trace_tree = self._salted_tree(trace_lde, trace_key)

        g = Domain.new(n).group_gen()
        t_rolls = [
            torch.roll(trace_lde, -k * cfg.blowup) for k in range(self.air.num_shifts)
        ]
        c_evals = self.air.constraint_lde(t_rolls, tabs["x"], g, n)
        q_evals = bb.mul(c_evals, tabs["zh_tile"])
        quot_tree = self._salted_tree(q_evals, quot_key)
        return trace_lde, q_evals, trace_tree, quot_tree

    def _ood(self, trace_lde, q_evals, x, z: int, N: int):
        """Barycentric values at z of T(x), T(gx), T(g^2 x) and Q from their
        eval vectors on the coset {x_i}: for a degree-<N polynomial,
        p(z) = (z^N - h^N)/(N h^N) * sum_i v_i x_i/(z - x_i).
        Returns the four host ints and (x_i - z)^-1 for DEEP."""
        blowup, shift = self.config.blowup, self.config.coset_shift
        inv_xz = bb.inv(bb.sub(x, z))
        w = bb.mul(x, inv_xz)
        sums = torch.stack([
            bb.sum_mod(bb.mul(v, w))
            for v in (
                trace_lde,
                torch.roll(trace_lde, -blowup),
                torch.roll(trace_lde, -2 * blowup),
                q_evals,
            )
        ]).tolist()
        h_N = pow(shift, N, P)
        pref = (pow(z, N, P) - h_N) * pow(N * h_N % P, P - 2, P) % P
        # 1/(z - x_i) = -1/(x_i - z)
        return [pref * (-s % P) % P for s in sums], inv_xz

    def _deep(self, trace_lde, q_evals, inv_xz, ood):
        blowup = self.config.blowup
        num = bb.sub(q_evals, ood[3])
        num = bb.add(num, bb.sub(torch.roll(trace_lde, -2 * blowup), ood[2]))
        num = bb.add(num, bb.sub(torch.roll(trace_lde, -blowup), ood[1]))
        num = bb.add(num, bb.sub(trace_lde, ood[0]))
        return bb.mul(num, inv_xz)

    def _fri_phase(self, d_evals, xs_inv, transcript, final_size):
        """Fold to the final layer, committing each layer. Returns
        (layers, trees, layer keys, commitments, final layer as ints)."""
        key0 = self._layer_key()
        tree0 = self._salted_tree(d_evals, key0)
        layers, trees, keys = [d_evals], [tree0], [key0]
        commitments = [tree0.root()]
        transcript.absorb_commitment(commitments[0])

        current = d_evals
        while current.shape[0] > final_size:
            beta = transcript.squeeze_challenge()
            half = current.shape[0] // 2
            current = fri_fold(current, xs_inv[:half], beta)
            xs_inv = bb.mul(xs_inv[:half], xs_inv[:half])
            if current.shape[0] == final_size:
                tree, key = build_unsalted_device_tree(current), None
            else:
                key = self._layer_key()
                tree = self._salted_tree(current, key)
            layers.append(current)
            trees.append(tree)
            keys.append(key)
            commitments.append(tree.root())
            transcript.absorb_commitment(commitments[-1])
        return layers, trees, keys, commitments, current.tolist()

    def _open(self, tree: DeviceTree, values, key, indices: list) -> list:
        """MerkleOpenings of `indices`: gathered values, sibling paths and
        (for a salted layer) the opened leaves' salts."""
        idx = torch.tensor(indices, dtype=I64, device=values.device)
        vals = values[idx].tolist()
        proofs = openings_from_paths(indices, extract_paths(tree.levels, idx),
                                     tree.depth)
        if key is None:
            salts = [b""] * len(indices)
        else:
            salts = [
                b"".join(int(w).to_bytes(4, "big") for w in row)
                for row in salts_mod.salts_for_indices(key, idx).tolist()
            ]
        return [
            MerkleOpening(i, v, p, s)
            for i, v, p, s in zip(indices, vals, proofs, salts)
        ]

    # ── main entry point ──────────────────────────────────────────────────

    def generate_proof(self) -> StarkProof:
        cfg, dev = self.config, self.device
        n = self.trace.num_rows
        N = n * cfg.blowup
        if N >= LEAFLESS_MIN:
            raise NotImplementedError(
                f"LDE 2^{N.bit_length() - 1}: pruned huge trees are not ported"
            )
        domain = Domain.new(n)
        g = domain.group_gen()
        tabs = phase_tables(n, N, cfg.coset_shift, str(dev))

        # ── commit (random draws: mask, trace salts, quotient salts) ──────
        r_mask = torch.from_numpy(
            self.rng.integers(0, P, cfg.mask_degree, dtype=np.uint64).astype(np.int64)
        ).to(dev)
        trace_col = torch.from_numpy(
            (self.trace.columns[0] % np.uint64(P)).astype(np.int64)
        ).to(dev)
        trace_key = self._layer_key()
        quot_key = self._layer_key()
        trace_lde, q_evals, trace_tree, quot_tree = self._commit(
            tabs, trace_col, r_mask, trace_key, quot_key, n
        )
        trace_root, quotient_root = trace_tree.root(), quot_tree.root()

        # ── Fiat-Shamir: the OOD point z ──────────────────────────────────
        transcript = Transcript()
        transcript.absorb_commitment(trace_root)
        transcript.absorb_commitment(quotient_root)
        z = derive_z(transcript, N, cfg.coset_shift)

        # ── OOD values and the prover-side constraint check ───────────────
        ood, inv_xz = self._ood(trace_lde, q_evals, tabs["x"], z, N)
        t_z, t_gz, t_ggz, q_z = ood
        c_z = self.air.constraint_at([t_z, t_gz, t_ggz], z, g, n)
        if c_z != q_z * domain.eval_vanishing(z) % P:
            raise ValueError("Constraint check at z failed — invalid trace")
        for v in ood:
            transcript.absorb_field(v)

        # ── DEEP and FRI ──────────────────────────────────────────────────
        d_evals = self._deep(trace_lde, q_evals, inv_xz, ood)
        final_size = cfg.final_layer_size(n)
        layers, trees, keys, fri_commitments, final = self._fri_phase(
            d_evals, tabs["xs_inv"], transcript, final_size
        )

        # ── queries ───────────────────────────────────────────────────────
        half0 = N // 2
        B = cfg.blowup
        query_indices = transcript.squeeze_indices(cfg.num_queries, half0)
        num_folds = len(layers) - 1
        trace_idx, deep_idx = [], []
        fri_idx = [[] for _ in range(1, num_folds)]
        for qi in query_indices:
            trace_idx += [qi, (qi + B) % N, (qi + 2 * B) % N]
            deep_idx += [qi, qi + half0]
            idx = qi
            for li in range(1, num_folds):
                half = layers[li].shape[0] // 2
                idx = idx % half
                fri_idx[li - 1] += [idx, idx + half]

        tr_ops = self._open(trace_tree, trace_lde, trace_key, trace_idx)
        q_ops = self._open(quot_tree, q_evals, quot_key, list(query_indices))
        d_ops = self._open(trees[0], layers[0], keys[0], deep_idx)
        f_ops = [
            self._open(trees[li], layers[li], keys[li], fri_idx[li - 1])
            for li in range(1, num_folds)
        ]

        query_proofs = [
            QueryProof(
                index=qi,
                deep_opening=d_ops[2 * q],
                deep_opening_pair=d_ops[2 * q + 1],
                trace_opening=tr_ops[3 * q],
                trace_opening_g=tr_ops[3 * q + 1],
                trace_opening_gg=tr_ops[3 * q + 2],
                quotient_opening=q_ops[q],
                fri_openings=[(ops[2 * q], ops[2 * q + 1]) for ops in f_ops],
            )
            for q, qi in enumerate(query_indices)
        ]
        return StarkProof(
            trace_len=n,
            lde_size=N,
            trace_commitment=trace_root,
            quotient_commitment=quotient_root,
            t_z=t_z,
            t_gz=t_gz,
            t_ggz=t_ggz,
            q_z=q_z,
            fri_commitments=fri_commitments,
            fri_final_layer=final,
            query_proofs=query_proofs,
            ext=False,
            hash=cfg.hash,
        )
