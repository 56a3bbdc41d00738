"""Proof data structures + serialization.

Field-for-field mirror of the reference's proof objects
(reference: src/fibonacci.rs:25-86) plus a canonical byte serialization the
reference lacks (it keeps proofs as in-memory structs only); the wire format
here makes proofs checkpointable and transportable between hosts.
"""

from __future__ import annotations

import io
import struct
from dataclasses import dataclass

from .merkle import MerkleProof


@dataclass
class MerkleOpening:
    """Opening of one position in a committed layer (src/fibonacci.rs:25-33).
    The leaf preimage is salt || value8LE (salt empty for unsalted trees)."""

    index: int
    value: int
    proof: MerkleProof
    salt: bytes


@dataclass
class QueryProof:
    """Everything needed to check one query position across all FRI layers
    (src/fibonacci.rs:37-59)."""

    index: int
    deep_opening: MerkleOpening
    deep_opening_pair: MerkleOpening
    trace_opening: MerkleOpening
    trace_opening_g: MerkleOpening
    trace_opening_gg: MerkleOpening
    quotient_opening: MerkleOpening
    fri_openings: list  # list[tuple[MerkleOpening, MerkleOpening]]
    # Multi-column / custom-shift AIRs: one opening per shift, each carrying
    # the k-tuple row bundle; the three fixed fields above are None.
    trace_openings: list = None


@dataclass
class StarkProof:
    """A complete STARK proof (src/fibonacci.rs:62-86).

    In the extension-field soundness mode (`ext=True`): t_z/t_gz/t_ggz/q_z,
    the final FRI layer, and the DEEP/FRI opening values are 4-tuples of ints
    (F_p^4 elements); trace/quotient openings stay base-field ints."""

    trace_len: int
    lde_size: int
    trace_commitment: bytes
    quotient_commitment: bytes
    t_z: object  # int | ExtScalar
    t_gz: object
    t_ggz: object
    q_z: object
    fri_commitments: list  # list[bytes]
    fri_final_layer: list  # list[int] | list[ExtScalar]
    query_proofs: list  # list[QueryProof]
    ext: bool = False
    # Multi-column mode (num_columns > 1 or num_shifts != 3): OOD trace
    # values as ood_trace[shift] = k-tuple; t_z/t_gz/t_ggz are None.
    ood_trace: tuple = None
    num_columns: int = 1
    num_shifts: int = 3
    # Merkle hash backend the commitments were built with ("sha256" — the
    # reference's hash — or "poseidon2"); see StarkConfig.hash.
    hash: str = "sha256"


# ── serialization (wire formats v1 / v2) ────────────────────────────────────
#
# All integers little-endian. v1 layout (base-field proofs — the reference
# protocol):
#   magic "TSTK" | u16 version | u64 trace_len | u64 lde_size
#   | 32B trace_commitment | 32B quotient_commitment
#   | u64 t_z t_gz t_ggz q_z
#   | u32 n_fri_commitments | 32B each
#   | u32 final_len | u64 each
#   | u32 n_queries | QueryProof each
# v2 (ext_challenges mode) differs only in the scalar widths: OOD values and
# final-layer entries are 32B (4 x u64 limbs, ext.h_to_bytes order), and each
# opening's value is prefixed with a u32 limb count (1 = base, 4 = ext).

# v3 (multi-column AIRs) adds u16 num_columns + u16 num_shifts to the header,
# replaces the t_z/t_gz/t_ggz trio with ns*k shift-major OOD values, and
# writes ns trace openings per query (limb-count-prefixed k-tuples).

# v4 = v3 + ext_challenges: OOD/final-layer/DEEP/FRI scalars are 32-byte
# ext values (trace openings stay k-tuples of base values).

# v5 (Poseidon2 commitments, any protocol shape) replaces the version-enum
# encoding of the mode with an explicit u16 flags field right after the
# version (bit 0 = ext_challenges, bit 1 = multi) and always uses the
# limb-prefixed opening encoding + the v3 header extras when multi. Digest
# widths are unchanged (a Poseidon2 digest is 8 BabyBear elements = 32
# bytes LE), so everything after the header is structurally identical to
# v1-v4. SHA-256 proofs keep serializing as v1-v4 byte-for-byte.

_MAGIC = b"TSTK"
_VERSION = 1
_VERSION_EXT = 2
_VERSION_MULTI = 3
_VERSION_MULTI_EXT = 4
_VERSION_P2 = 5
_FLAG_EXT = 1
_FLAG_MULTI = 2


def _w_scalar(buf, v, ext: bool):
    if ext:
        for limb in v:
            _w_u64(buf, limb)
    else:
        _w_u64(buf, v)


def _r_scalar(buf, ext: bool):
    if ext:
        return tuple(_r_u64(buf) for _ in range(4))
    return _r_u64(buf)


def _w_u16(buf, v): buf.write(struct.pack("<H", v))
def _w_u32(buf, v): buf.write(struct.pack("<I", v))
def _w_u64(buf, v): buf.write(struct.pack("<Q", v))
def _r_u16(buf): return struct.unpack("<H", _r_bytes(buf, 2))[0]
def _r_u32(buf): return struct.unpack("<I", _r_bytes(buf, 4))[0]
def _r_u64(buf): return struct.unpack("<Q", _r_bytes(buf, 8))[0]


# Deserialization is hostile-input hardened: every read is bounds-checked and
# every count field is validated against the bytes actually remaining, so a
# corrupt blob raises ValueError promptly instead of looping ~2^32 times on
# an exhausted buffer or silently yielding short reads. (The verifier is the
# soundness boundary; this is the availability boundary.)

def _r_bytes(buf, n: int) -> bytes:
    b = buf.read(n)
    if len(b) != n:
        raise ValueError("truncated proof")
    return b


def _r_count(buf, item_min_bytes: int) -> int:
    """Read a u32 element count and reject it unless `count * minimum
    per-element size` fits in the remaining buffer."""
    n = _r_u32(buf)
    remaining = buf.getbuffer().nbytes - buf.tell()
    if n * item_min_bytes > remaining:
        raise ValueError("corrupt proof: count exceeds remaining bytes")
    return n


def _write_opening(buf, op: MerkleOpening, v2: bool = False):
    _w_u64(buf, op.index)
    if v2:
        if isinstance(op.value, tuple):
            _w_u32(buf, len(op.value))
            for limb in op.value:
                _w_u64(buf, limb)
        else:
            _w_u32(buf, 1)
            _w_u64(buf, op.value)
    else:
        _w_u64(buf, op.value)
    _w_u32(buf, len(op.salt))
    buf.write(op.salt)
    _w_u32(buf, len(op.proof.path))
    for sib, pos in zip(op.proof.path, op.proof.position):
        buf.write(sib)
        buf.write(b"\x01" if pos else b"\x00")


def _read_opening(buf, v2: bool = False) -> MerkleOpening:
    index = _r_u64(buf)
    if v2:
        nlimbs = _r_count(buf, 8)
        if nlimbs > 1:
            value = tuple(_r_u64(buf) for _ in range(nlimbs))
        else:
            value = _r_u64(buf)
    else:
        value = _r_u64(buf)
    salt = _r_bytes(buf, _r_count(buf, 1))
    n = _r_count(buf, 33)
    path, position = [], []
    for _ in range(n):
        path.append(_r_bytes(buf, 32))
        position.append(_r_bytes(buf, 1) == b"\x01")
    return MerkleOpening(index, value, MerkleProof(path, position), salt)


def serialize(proof: StarkProof) -> bytes:
    multi = proof.ood_trace is not None
    p2 = proof.hash != "sha256"
    v2 = proof.ext or multi or p2  # limb-prefixed opening encoding
    buf = io.BytesIO()
    buf.write(_MAGIC)
    if p2:
        version = _VERSION_P2
    elif multi:
        version = _VERSION_MULTI_EXT if proof.ext else _VERSION_MULTI
    else:
        version = _VERSION_EXT if proof.ext else _VERSION
    _w_u16(buf, version)
    if p2:
        _w_u16(buf, (_FLAG_EXT if proof.ext else 0)
               | (_FLAG_MULTI if multi else 0))
    _w_u64(buf, proof.trace_len)
    _w_u64(buf, proof.lde_size)
    if multi:
        _w_u16(buf, proof.num_columns)
        _w_u16(buf, proof.num_shifts)
    buf.write(proof.trace_commitment)
    buf.write(proof.quotient_commitment)
    if multi:
        for row in proof.ood_trace:
            for v in row:
                _w_scalar(buf, v, proof.ext)
        _w_scalar(buf, proof.q_z, proof.ext)
    else:
        for v in (proof.t_z, proof.t_gz, proof.t_ggz, proof.q_z):
            _w_scalar(buf, v, proof.ext)
    _w_u32(buf, len(proof.fri_commitments))
    for c in proof.fri_commitments:
        buf.write(c)
    _w_u32(buf, len(proof.fri_final_layer))
    for v in proof.fri_final_layer:
        _w_scalar(buf, v, proof.ext)
    _w_u32(buf, len(proof.query_proofs))
    for qp in proof.query_proofs:
        _w_u64(buf, qp.index)
        for op in (qp.deep_opening, qp.deep_opening_pair):
            _write_opening(buf, op, v2)
        if multi:
            for op in qp.trace_openings:
                _write_opening(buf, op, v2)
        else:
            for op in (qp.trace_opening, qp.trace_opening_g,
                       qp.trace_opening_gg):
                _write_opening(buf, op, v2)
        _write_opening(buf, qp.quotient_opening, v2)
        _w_u32(buf, len(qp.fri_openings))
        for a, b in qp.fri_openings:
            _write_opening(buf, a, v2)
            _write_opening(buf, b, v2)
    return buf.getvalue()


def deserialize(data: bytes) -> StarkProof:
    buf = io.BytesIO(data)
    if _r_bytes(buf, 4) != _MAGIC:
        raise ValueError("bad magic")
    version = _r_u16(buf)
    if version not in (_VERSION, _VERSION_EXT, _VERSION_MULTI,
                       _VERSION_MULTI_EXT, _VERSION_P2):
        raise ValueError("unsupported proof version")
    p2 = version == _VERSION_P2
    if p2:
        flags = _r_u16(buf)
        if flags & ~(_FLAG_EXT | _FLAG_MULTI):
            raise ValueError("unknown proof flags")
        ext = bool(flags & _FLAG_EXT)
        multi = bool(flags & _FLAG_MULTI)
    else:
        ext = version in (_VERSION_EXT, _VERSION_MULTI_EXT)
        multi = version in (_VERSION_MULTI, _VERSION_MULTI_EXT)
    v2 = ext or multi or p2
    trace_len = _r_u64(buf)
    lde_size = _r_u64(buf)
    k = _r_u16(buf) if multi else 1
    ns = _r_u16(buf) if multi else 3
    scalar_bytes = 32 if ext else 8
    if multi:
        remaining = buf.getbuffer().nbytes - buf.tell()
        if (ns * k + 1) * scalar_bytes > remaining:
            raise ValueError("corrupt proof: OOD block exceeds remaining bytes")
    trace_commitment = _r_bytes(buf, 32)
    quotient_commitment = _r_bytes(buf, 32)
    if multi:
        ood_trace = tuple(
            tuple(_r_scalar(buf, ext) for _ in range(k)) for _ in range(ns)
        )
        t_z = t_gz = t_ggz = None
        q_z = _r_scalar(buf, ext)
    else:
        ood_trace = None
        t_z, t_gz, t_ggz, q_z = (_r_scalar(buf, ext) for _ in range(4))
    fri_commitments = [_r_bytes(buf, 32) for _ in range(_r_count(buf, 32))]
    fri_final_layer = [
        _r_scalar(buf, ext) for _ in range(_r_count(buf, scalar_bytes))
    ]
    query_proofs = []
    for _ in range(_r_count(buf, 8)):
        index = _r_u64(buf)
        deep_a = _read_opening(buf, v2)
        deep_b = _read_opening(buf, v2)
        if multi:
            trace_ops = [_read_opening(buf, v2) for _ in range(ns)]
            t0 = tg = tgg = None
        else:
            trace_ops = None
            t0, tg, tgg = (_read_opening(buf, v2) for _ in range(3))
        quot = _read_opening(buf, v2)
        fri_openings = []
        for _ in range(_r_count(buf, 2 * 20)):
            a = _read_opening(buf, v2)
            b = _read_opening(buf, v2)
            fri_openings.append((a, b))
        query_proofs.append(
            QueryProof(index, deep_a, deep_b, t0, tg, tgg, quot,
                       fri_openings, trace_openings=trace_ops)
        )
    return StarkProof(
        trace_len, lde_size, trace_commitment, quotient_commitment,
        t_z, t_gz, t_ggz, q_z, fri_commitments, fri_final_layer, query_proofs,
        ext=ext, ood_trace=ood_trace, num_columns=k, num_shifts=ns,
        hash="poseidon2" if p2 else "sha256",
    )
