"""Protocol configuration.

The reference hard-codes these as compile-time consts
(reference: src/fibonacci.rs:11-19); here they are a frozen dataclass so the
framework is parameterizable while the defaults reproduce the reference
protocol exactly.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class StarkConfig:
    """Defaults = the reference protocol (soundness ~= (1/8)^44 ~ 2^-132)."""

    # Spot-check queries; at rate 1/8 each gives ~3 bits (src/fibonacci.rs:10-11)
    num_queries: int = 44
    # LDE blowup keeping the tested RS rate at 1/8 after masking
    # (src/fibonacci.rs:12-14)
    blowup: int = 32
    # Coset shift for the LDE domain (src/fibonacci.rs:15-16)
    coset_shift: int = 7
    # Extension-field soundness mode: draw z and the FRI betas from F_p^4
    # (~124-bit challenge space). The reference ships the Ext building blocks
    # and documents this intent (src/ext.rs:1-12) but its own pipeline stays
    # base-field; False reproduces the reference protocol byte-for-byte.
    ext_challenges: bool = False
    # Merkle hash backend: "sha256" (the reference's hash, byte-exact
    # transcripts — src/merkle.rs:105-123) or "poseidon2" (arithmetic hash
    # over BabyBear: rounds are field ops on the VPU and digests are field
    # elements, the property recursive verification needs; wire format v5).
    # The Fiat-Shamir transcript stays SHA-256 either way — only the
    # commitment trees change.
    hash: str = "sha256"
    # Algebraic degree of the composed constraint in the trace polynomials.
    # Both reference constraints are LINEAR in T (the Fibonacci transition is
    # T(g^2 x) - T(g x) - T(x) times degree-2 boundary factors,
    # src/fibonacci.rs:315-325), so 1 reproduces the reference FRI schedule.
    # Nonlinear AIRs (e.g. x^7 S-box chains) raise deg(Q) = deg(C) - n and
    # must widen the FRI degree budget accordingly.
    constraint_degree: int = 1

    @property
    def mask_degree(self) -> int:
        """Random blinding coefficients per trace polynomial: covers every
        revealed trace evaluation — 3 openings per query + 3 OOD points + the
        reference's margin (src/fibonacci.rs:17-19)."""
        return 3 * self.num_queries + 8

    def fri_degree_bound(self, trace_len: int) -> int:
        """The power-of-two degree budget the FRI schedule proves the DEEP
        codeword below. With L = trace_len + mask_degree it covers both the
        masked trace polynomial (deg L-1) and the quotient
        (deg <= d*(L-1) + 2 - trace_len for a degree-d constraint with
        degree-<=2 boundary factors). d=1 gives next_pow2(L) — exactly the
        reference's schedule (src/fibonacci.rs:220, src/verifier.rs:59)."""
        L = trace_len + self.mask_degree
        q_deg = self.constraint_degree * (L - 1) + 2 - trace_len
        v = max(L, q_deg)
        return 1 << (v - 1).bit_length()

    def final_layer_size(self, trace_len: int) -> int:
        return trace_len * self.blowup // self.fri_degree_bound(trace_len)


DEFAULT_CONFIG = StarkConfig()
