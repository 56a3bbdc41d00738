"""Fiat-Shamir transcript — host-side, byte-exact.

This is the sequential heart of the protocol and deliberately stays on the
host: every byte it absorbs and every challenge it squeezes must match the
reference bit-for-bit (reference: src/transcript.rs), because prover and
verifier replay identical transcripts. Device work only feeds it inputs
(Merkle roots, OOD scalars) at coarse phase boundaries.

State evolution (src/transcript.rs:12-39):
  state := b"toyni-stark-v1"; absorb appends bytes;
  squeeze: h = SHA256(state); state = h; challenge = LE64(h[0..8]) mod p.
Index squeezing ratchets the same way and dedups (src/transcript.rs:58-72).
"""

from __future__ import annotations

import hashlib

from .field import babybear as bb
from .field import ext as extf
from .field.babybear import P

SEED = b"toyni-stark-v1"


def digest_sha2(data: bytes) -> bytes:
    """One-shot SHA-256 (the reference's shared helper, src/lib.rs:14-18)."""
    return hashlib.sha256(data).digest()


class Transcript:
    def __init__(self):
        self.state = bytearray(SEED)

    def absorb(self, data: bytes) -> None:
        self.state.extend(data)

    def absorb_field(self, value: int) -> None:
        """8-byte LE encoding (src/transcript.rs:24-26)."""
        self.absorb(bb.to_bytes(value))

    def absorb_commitment(self, root: bytes) -> None:
        self.absorb(root)

    def absorb_ext(self, value: extf.ExtScalar) -> None:
        """32-byte LE encoding (src/transcript.rs:53-55)."""
        self.absorb(extf.h_to_bytes(value))

    def squeeze_challenge(self) -> int:
        """Hash-ratchet then map to BabyBear (src/transcript.rs:34-39)."""
        h = digest_sha2(bytes(self.state))
        self.state = bytearray(h)
        return bb.from_bytes_mod_order(h)

    def squeeze_ext_challenge(self) -> extf.ExtScalar:
        """Four independent base squeezes (src/transcript.rs:43-50)."""
        return (
            self.squeeze_challenge(),
            self.squeeze_challenge(),
            self.squeeze_challenge(),
            self.squeeze_challenge(),
        )

    def squeeze_indices(self, count: int, max_value: int) -> list:
        """`count` *distinct* indices in [0, max_value); every ratchet counts
        even when the sample is a duplicate (src/transcript.rs:58-72)."""
        indices = []
        seen = set()
        while len(indices) < count:
            h = digest_sha2(bytes(self.state))
            self.state = bytearray(h)
            idx = int.from_bytes(h[:8], "little") % max_value
            if idx not in seen:
                seen.add(idx)
                indices.append(idx)
        return indices


def derive_z(transcript: Transcript, lde_size: int, shift: int) -> int:
    """Rejection-sample the out-of-domain point z (src/fibonacci.rs:377-399,
    mirrored at src/verifier.rs:246-267).

    The reference materializes HashSets of both LDE domains and additionally
    rejects z with g·z or g²·z in the shifted domain. Since the standard
    domain is exactly the group of lde_size-th roots of unity and g is in
    that group, those four membership tests reduce to two exact power checks:
        z in <omega>            ⟺  z^N == 1
        z, g·z, g²·z in h<omega> ⟺  z^N == h^N
    (and z = 0 fails both but is also not invertible; 0^N == 0 ≠ 1, h^N ≠ 0,
    so 0 is accepted by the reference's set test too — and indeed the
    reference would accept z = 0. We preserve that behavior exactly: the
    rejection loop and every ratchet it performs match byte-for-byte.)
    """
    h_n = pow(shift, lde_size, P)
    while True:
        z = transcript.squeeze_challenge()
        zn = pow(z, lde_size, P)
        if zn != 1 and zn != h_n:
            return z


def derive_z_ext(transcript: Transcript, lde_size: int, shift: int) -> extf.ExtScalar:
    """Ext-challenge analog of `derive_z` (the extension-field soundness mode;
    the reference documents the intent at src/ext.rs:1-12 but its pipeline
    draws z from the base field). The forbidden sets — both LDE domains and
    their g/g² translates — live entirely in the base field, so an ext sample
    can only collide when its three high coefficients are zero; the rejection
    test is then the same two power checks as the base path. Every rejected
    sample ratchets the transcript, mirroring fibonacci.rs:389-398."""
    h_n = pow(shift, lde_size, P)
    while True:
        z = transcript.squeeze_ext_challenge()
        if z[1] == 0 and z[2] == 0 and z[3] == 0:
            zn = pow(z[0], lde_size, P)
            if zn == 1 or zn == h_n:
                continue
        return z
