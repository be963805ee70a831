"""Counter-based random draws: every random tensor of a generation, for
every row, in one launch.

``draws(key, ctr, slots)`` fills one ``(R, *slot.shape)`` tensor a slot
from the Philox4x32-10 stream of each row, and returns them with the
next counter, ``ctr + 1``: ``key`` is ``(R, 2)`` int64 holding a row's
two 32-bit key words and ``ctr`` ``(R,)`` int64 its generation counter.
Element ``e`` of slot ``s`` of row ``r`` is word ``e % 4`` of the Philox
block at counter ``(e // 4, s, ctr[r] mod 2**32, ctr[r] >> 32)`` under
key ``key[r]``, so a row's draws are a pure
function of its key, its counter, the slot and the element: they do not
depend on R or on the other rows.  A 32-bit word ``u`` becomes

  float   ``(u >> 8) * 2**-24``: in [0, 1) exactly, on a 2**-24 grid;
  int     ``lo + ((u * (hi - lo)) >> 32)`` (multiply-shift) in [lo, hi),
          int32; a value's share differs from ``1 / (hi - lo)`` by less
          than ``(hi - lo) / 2**32`` (under 3e-8 at MAGMA's widest range,
          the group size);
  bool    ``u < 2**31``: the float's ``< 0.5``.

A CUDA tensor goes to the hand-written kernel ``csrc/draws.cu`` (one
launch for all slots and rows; see the note at the top of that file); a
CPU tensor goes to the plain PyTorch version, :func:`draws_plain`, the
same Philox in int64 tensor ops over every row and slot at once.  There
is no fallback from one to the other: a CUDA call builds and launches the
kernel or raises.  The kernel reads ``key`` and ``ctr`` from device
memory, so a CUDA graph that captured a launch draws the counter the
state holds at each replay, and writes the next counter itself.

``LAUNCHES["draws"]`` counts the kernel's launches on the path as
``makespan.LAUNCHES`` counts the makespan kernel's (``_build``'s launch
counts: a CUDA graph's replay adds the launches captured into it); the
process registry's ``repro_draws_launches_total`` counts the same.
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Sequence, Tuple

import torch

from repro_torch.kernels import _build

# Philox4x32's multipliers and Weyl key increments (Salmon et al., SC'11)
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
ROUNDS = 10
MAX_SLOTS = 16              # the kernel's slot table
_MASK = 0xFFFFFFFF
_KINDS = {"float": (0, torch.float32), "int": (1, torch.int32),
          "bool": (2, torch.bool)}

LAUNCHES = _build.launch_counter("draws", "repro_draws_launches_total",
                                 "Launches of the counter-based draw kernel")


def reset_launches() -> None:
    """Set ``LAUNCHES`` to 0 (the registry's counter keeps counting)."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class Slot(NamedTuple):
    """One random tensor: a row's ``shape``, its ``kind`` ("float",
    "int" or "bool") and, for "int", its range [lo, hi)."""
    shape: Tuple[int, ...]
    kind: str
    lo: int = 0
    hi: int = 0


def _check(key: torch.Tensor, ctr: torch.Tensor, slots: Sequence[Slot]):
    if key.dim() != 2 or key.shape[1] != 2 or key.dtype != torch.int64:
        raise ValueError(f"key must be (R, 2) int64; got "
                         f"{tuple(key.shape)} {key.dtype}")
    if ctr.shape != key.shape[:1] or ctr.dtype != torch.int64:
        raise ValueError(f"ctr must be (R,)={tuple(key.shape[:1])} int64; "
                         f"got {tuple(ctr.shape)} {ctr.dtype}")
    if ctr.device != key.device:
        raise ValueError("key and ctr must be on one device")
    if not 1 <= len(slots) <= MAX_SLOTS:
        raise ValueError(f"1..{MAX_SLOTS} slots a launch; got {len(slots)}")
    for s in slots:
        if s.kind not in _KINDS:
            raise ValueError(f"unknown slot kind {s.kind!r}")
        if s.kind == "int" and not (-2 ** 31 <= s.lo < s.hi <= 2 ** 31
                                    and s.hi - s.lo < 2 ** 31):
            raise ValueError(f"an int slot needs -2**31 <= lo < hi <= 2**31 "
                             f"and hi - lo < 2**31; got [{s.lo}, {s.hi})")
        if _numel(s) >= 4 * 2 ** 32:
            raise ValueError(f"a slot holds fewer than 2**34 values a row; "
                             f"got {s.shape}")


def _numel(slot: Slot) -> int:
    n = 1
    for d in slot.shape:
        n *= int(d)
    return n


def _mulhilo(m: int, c: torch.Tensor):
    """(hi, lo) 32-bit words of ``m * c`` for ``c`` in [0, 2**32): the
    product split so that no int64 intermediate overflows."""
    a = (c & 0xFFFF) * m                     # < 2**48
    b = (c >> 16) * m                        # < 2**48
    s = a + ((b & 0xFFFF) << 16)             # < 2**49
    return (b >> 16) + (s >> 32), s & _MASK


def philox(c0, c1, c2, c3, k0, k1) -> List[torch.Tensor]:
    """Philox4x32-10 of the counter words ``c0..c3`` under the key words
    ``k0, k1`` (int64 tensors holding 32-bit words, broadcast together):
    the block's four words, int64 in [0, 2**32)."""
    c = [c0, c1, c2, c3]
    for r in range(ROUNDS):
        if r:
            k0 = (k0 + PHILOX_W[0]) & _MASK
            k1 = (k1 + PHILOX_W[1]) & _MASK
        hi0, lo0 = _mulhilo(PHILOX_M[0], c[0])
        hi1, lo1 = _mulhilo(PHILOX_M[1], c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return c


def _convert(u: torch.Tensor, slot: Slot) -> torch.Tensor:
    if slot.kind == "float":
        return (u >> 8).to(torch.float32) * 2.0 ** -24
    if slot.kind == "bool":
        return u < 2 ** 31
    return (slot.lo + ((u * (slot.hi - slot.lo)) >> 32)).to(torch.int32)


# lint: dispatch
def draws_plain(key: torch.Tensor, ctr: torch.Tensor, slots: Sequence[Slot]
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The plain PyTorch version: every row's and slot's Philox blocks in
    one pass of int64 tensor ops."""
    _check(key, ctr, slots)
    dev, R = key.device, key.shape[0]
    blocks = [(_numel(s) + 3) // 4 for s in slots]
    c0 = torch.cat([torch.arange(b, device=dev) for b in blocks])
    c1 = torch.cat([torch.full((b,), i, device=dev, dtype=torch.int64)
                    for i, b in enumerate(blocks)])
    words = philox(c0[None], c1[None], (ctr & _MASK)[:, None],
                   (ctr >> 32)[:, None], key[:, :1], key[:, 1:])
    words = torch.stack(torch.broadcast_tensors(*words), dim=-1).reshape(
        R, -1)                                         # (R, 4 * sum(blocks))
    out, at = [], 0
    for s, b in zip(slots, blocks):
        u = words[:, 4 * at:4 * at + _numel(s)]
        out.append(_convert(u, s).reshape((R,) + tuple(s.shape)))
        at += b
    return out, ctr + 1


class _SlotC(ctypes.Structure):
    _fields_ = [("out", ctypes.c_void_p), ("numel", ctypes.c_longlong),
                ("first_block", ctypes.c_longlong), ("kind", ctypes.c_int),
                ("lo", ctypes.c_int), ("span", ctypes.c_uint)]


class _SlotsC(ctypes.Structure):
    _fields_ = [("slot", _SlotC * MAX_SLOTS), ("count", ctypes.c_int),
                ("blocks_per_row", ctypes.c_longlong)]


def _library() -> ctypes.CDLL:
    lib = _build.load("draws").lib
    lib.draws_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.POINTER(_SlotsC),
                                 ctypes.c_int, ctypes.c_void_p]
    lib.draws_launch.restype = ctypes.c_int
    lib.draws_error_string.argtypes = [ctypes.c_int]
    lib.draws_error_string.restype = ctypes.c_char_p
    return lib


# lint: dispatch
def draws_cuda(key: torch.Tensor, ctr: torch.Tensor, slots: Sequence[Slot]
               ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Launch the CUDA kernel on PyTorch's current stream (no sync): one
    launch writes every slot of every row and the next counter."""
    _check(key, ctr, slots)
    if key.device.type != "cuda":
        raise ValueError(f"draws_cuda needs CUDA tensors; got {key.device}")
    if not (key.is_contiguous() and ctr.is_contiguous()):
        raise ValueError("key and ctr must be contiguous")
    R = key.shape[0]
    out = [torch.empty((R,) + tuple(s.shape), dtype=_KINDS[s.kind][1],
                       device=key.device) for s in slots]
    table, first = _SlotsC(), 0
    for i, (s, t) in enumerate(zip(slots, out)):
        numel = _numel(s)
        table.slot[i] = _SlotC(t.data_ptr(), numel, first, _KINDS[s.kind][0],
                               s.lo if s.kind == "int" else 0,
                               s.hi - s.lo if s.kind == "int" else 0)
        first += (numel + 3) // 4
    table.count, table.blocks_per_row = len(slots), first
    if R == 0 or first == 0:           # nothing to draw (no children)
        return out, ctr + 1
    ctr_next = torch.empty_like(ctr)
    lib = _library()
    with torch.cuda.device(key.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.draws_launch(key.data_ptr(), ctr.data_ptr(),
                               ctr_next.data_ptr(), ctypes.byref(table), R,
                               stream)
    if err != 0:
        raise RuntimeError("draw kernel launch failed: "
                           + lib.draws_error_string(err).decode())
    _build.count_launch("draws")
    return out, ctr_next


# lint: dispatch
def draws(key: torch.Tensor, ctr: torch.Tensor, slots: Sequence[Slot]
          ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """One ``(R, *slot.shape)`` tensor a slot, and ``ctr + 1``: the CUDA
    kernel for CUDA tensors, the plain PyTorch version for CPU
    tensors."""
    if key.device.type == "cuda":
        return draws_cuda(key, ctr, slots)
    if key.device.type != "cpu":
        raise ValueError(f"no draw kernel for {key.device} tensors")
    return draws_plain(key, ctr, slots)
