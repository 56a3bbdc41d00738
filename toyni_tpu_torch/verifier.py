"""STARK verifier — host-side and scalar.

The base path of `toyni_tpu.verifier.StarkVerifier`: replays the
Fiat-Shamir transcript, checks the OOD constraint identity, the FRI final
layer's constancy and commitment, every query's Merkle openings (bound to
their index), the DEEP reconstruction and the whole fold chain. Exact Python
ints and hashlib only; no torch.

The modes the port does not prove yet (extension-field challenges,
Poseidon2 trees, other AIRs) raise NotImplementedError.
"""

from __future__ import annotations

from .air import FibonacciAir, require_ported
from .config import DEFAULT_CONFIG, StarkConfig
from .field.babybear import P, get_root_of_unity
from .merkle import host_tree_root, verify_merkle_proof
from .proof import MerkleOpening, StarkProof
from .transcript import Transcript, derive_z


def _value_bytes(value: int) -> bytes:
    """Leaf value encoding: 8-byte little-endian."""
    return int(value).to_bytes(8, "little")


def _verify_opening(opening: MerkleOpening, root: bytes, expected_index: int,
                    tree_size: int) -> bool:
    """Leaf = salt || value bytes. The position flags must spell
    `expected_index` (LSB first) and the path must span the tree's depth, so
    the opening proves exactly the queried position."""
    if opening.index != expected_index:
        return False
    for l, flag in enumerate(opening.proof.position):
        if flag != bool((expected_index >> l) & 1):
            return False
    if len(opening.proof.path) != (tree_size - 1).bit_length():
        return False
    if isinstance(opening.value, tuple):
        return False
    leaf = opening.salt + _value_bytes(opening.value)
    return verify_merkle_proof(leaf, opening.proof, root)


class StarkVerifier:
    def __init__(self, air: FibonacciAir | None = None,
                 config: StarkConfig = DEFAULT_CONFIG):
        self.air = air or FibonacciAir()
        self.config = config
        require_ported(self.air, config)

    def verify(self, proof: StarkProof) -> bool:
        cfg = self.config
        n = proof.trace_len
        N = proof.lde_size
        if N != n * cfg.blowup:
            return False
        if proof.ext or proof.hash != cfg.hash or proof.ood_trace is not None:
            return False
        if any(isinstance(v, tuple)
               for v in (proof.t_z, proof.t_gz, proof.t_ggz, proof.q_z)):
            return False

        g = get_root_of_unity(n.bit_length() - 1)
        omega_N = get_root_of_unity(N.bit_length() - 1)
        shift = cfg.coset_shift

        # ── 1. replay the Fiat-Shamir transcript ──────────────────────────
        transcript = Transcript()
        transcript.absorb_commitment(proof.trace_commitment)
        transcript.absorb_commitment(proof.quotient_commitment)
        z = derive_z(transcript, N, shift)
        for v in (proof.t_z, proof.t_gz, proof.t_ggz, proof.q_z):
            transcript.absorb_field(v)

        # ── 2. OOD constraint check: C(z) = Q(z) * Z_H(z) ─────────────────
        c_z = self.air.constraint_at([proof.t_z, proof.t_gz, proof.t_ggz], z, g, n)
        if c_z != proof.q_z * ((pow(z, n, P) - 1) % P) % P:
            return False

        # ── 3. FRI schedule, final layer constant and committed ──────────
        if not proof.fri_commitments:
            return False
        final_size = cfg.final_layer_size(n)
        expected_folds = (N // final_size).bit_length() - 1
        if len(proof.fri_commitments) != expected_folds + 1:
            return False
        if len(proof.fri_final_layer) != final_size:
            return False
        if any(v != proof.fri_final_layer[0] for v in proof.fri_final_layer):
            return False
        final_root = host_tree_root([_value_bytes(v) for v in proof.fri_final_layer])
        if final_root != proof.fri_commitments[-1]:
            return False

        transcript.absorb_commitment(proof.fri_commitments[0])
        fri_betas = []
        for i in range(1, len(proof.fri_commitments)):
            fri_betas.append(transcript.squeeze_challenge())
            transcript.absorb_commitment(proof.fri_commitments[i])

        # ── 4. query indices ──────────────────────────────────────────────
        half0 = N // 2
        query_indices = transcript.squeeze_indices(cfg.num_queries, half0)
        if len(proof.query_proofs) != cfg.num_queries:
            return False

        def shifted_element(i: int) -> int:
            return shift * pow(omega_N, i, P) % P

        half_inv = (P + 1) // 2

        def fold(a: int, b: int, beta: int, x: int) -> int:
            avg = (a + b) * half_inv % P
            diff = (a - b) * half_inv % P
            return (avg + diff * beta % P * pow(x, P - 2, P)) % P

        # ── 5. per-query checks ───────────────────────────────────────────
        for qi, qp in zip(query_indices, proof.query_proofs):
            if qp.index != qi:
                return False
            if len(qp.fri_openings) != expected_folds - 1:
                return False
            if qp.trace_opening is None:
                return False
            for s, op in enumerate((qp.trace_opening, qp.trace_opening_g,
                                    qp.trace_opening_gg)):
                if not _verify_opening(op, proof.trace_commitment,
                                       (qi + s * cfg.blowup) % N, N):
                    return False
            if not _verify_opening(qp.quotient_opening,
                                   proof.quotient_commitment, qi, N):
                return False
            if not _verify_opening(qp.deep_opening, proof.fri_commitments[0],
                                   qi, N):
                return False
            if not _verify_opening(qp.deep_opening_pair,
                                   proof.fri_commitments[0], qi + half0, N):
                return False

            # DEEP reconstruction from the opened and OOD values
            x_i = shifted_element(qi)
            num = (
                (qp.quotient_opening.value - proof.q_z)
                + (qp.trace_opening_gg.value - proof.t_ggz)
                + (qp.trace_opening_g.value - proof.t_gz)
                + (qp.trace_opening.value - proof.t_z)
            ) % P
            if qp.deep_opening.value != num * pow((x_i - z) % P, P - 2, P) % P:
                return False

            # the fold chain, layer 0 -> the final layer
            prev = fold(qp.deep_opening.value, qp.deep_opening_pair.value,
                        fri_betas[0], x_i)
            pos = qi
            for layer, (op, op_pair) in enumerate(qp.fri_openings):
                fold_k = layer + 1
                layer_size = N >> fold_k
                half = layer_size // 2
                lo = pos % half
                if not _verify_opening(op, proof.fri_commitments[fold_k],
                                       lo, layer_size):
                    return False
                if not _verify_opening(op_pair, proof.fri_commitments[fold_k],
                                       lo + half, layer_size):
                    return False
                if (op.value if pos == lo else op_pair.value) != prev:
                    return False
                x = pow(shifted_element(lo), 1 << fold_k, P)
                prev = fold(op.value, op_pair.value, fri_betas[fold_k], x)
                pos = lo
            if proof.fri_final_layer[pos] != prev:
                return False
        return True
