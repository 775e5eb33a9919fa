"""Dictionary-string kernels: the char-table encoder, K4 (match table), K5
(LIKE table) and K6 (substring), their wrappers and plain versions, and
the routes the string expressions take through them.

A string column is int32 codes into a sorted host dictionary, so every
string function splits into work per dictionary entry and a gather by
code. The per-entry work runs on the card over the dictionary's padded
char table (``encode_dictionary``: uint8[n, L] with L a power of two up
to 512, plus byte lengths), encoded once per dictionary and cached on the
column.

``match_table`` replaces spark_rapids_tpu/native/kernels/strings.py
``_match_table``: one bool per entry for starts / ends / contains. It is
bound by the table's bytes; ``csrc/strings.cu`` takes the needle by value
in the launch's parameters (no copy to the card per call), reads rows
with 16-byte loads (a thread per row up to 64 bytes, a group of lanes per
row past that), and answers ``contains`` in one shift-and pass per row
for needles up to 64 bytes. Unlike the TPU kernel it builds no window
tensor, so ``contains`` has no size budget.

``like_table`` replaces ``_like_table`` (same file): SQL LIKE per entry,
greedy over the pattern's ``%``-separated segments (exact for segments
of fixed length), ``_`` matching one byte. The pattern is parsed once per
(pattern, escape) (``like_spec``) and reaches the card by value in the
launch's parameters, as K4's needle does; a thread walks its row in one
shift-and pass for bodies up to 64 bytes. Like K4 it has no window
budget.

``substring_table`` replaces the kernel of ``substring_colv`` (same
file): Spark ``substring(pos, len)`` over an ASCII table, one thread per
16-byte output chunk, bound by the table's bytes in and out. The host
then rebuilds the sorted dictionary of the slices and remaps the codes.

Routes the reference takes by content stay: an entry longer than 512
bytes gives no table, ``substring`` and a LIKE pattern with ``_`` need
an ASCII dictionary (they count characters), and an empty dictionary has
no table; the expression then runs its host transform. Each wrapper
launches its CUDA kernel for CUDA tensors, or raises, and runs its plain
version for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import DEFAULT_DEVICE
from spark_rapids_tpu_torch import kernels as nk

#: longest entry, in bytes, the char table holds (the reference's ceiling)
MAX_ENTRY_LEN = 512
KINDS = {"starts": 0, "ends": 1, "contains": 2}


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def encode_dictionary(dic: np.ndarray
                      ) -> Optional[Tuple[np.ndarray, np.ndarray, bool]]:
    """(chars uint8[n, L], lens int32[n], ascii_only) for a dictionary, or
    None when an entry exceeds ``MAX_ENTRY_LEN`` bytes: the reference's
    ``encode_dictionary``, scattered in one vectorized step instead of a
    loop per entry."""
    n = len(dic)
    encoded = [str(s).encode("utf-8") for s in dic]
    lens = np.fromiter(map(len, encoded), dtype=np.int64, count=n)
    maxlen = int(lens.max()) if n else 0
    if maxlen > MAX_ENTRY_LEN:
        return None
    L = _pow2(max(maxlen, 1))
    chars = np.zeros((n, L), dtype=np.uint8)
    flat = np.frombuffer(b"".join(encoded), dtype=np.uint8)
    starts = np.cumsum(lens) - lens
    chars[np.repeat(np.arange(n), lens),
          np.arange(flat.size) - np.repeat(starts, lens)] = flat
    ascii_only = maxlen == 0 or int(flat.max()) < 0x80
    return chars, lens.astype(np.int32), ascii_only


class CharTable(NamedTuple):
    chars: torch.Tensor  # uint8[n, L]
    lens: torch.Tensor   # int32[n]
    ascii_only: bool


def table_from_reference(chars: np.ndarray, lens: np.ndarray,
                         device=DEFAULT_DEVICE) -> CharTable:
    """The port's char table from a reference ``encode_dictionary``
    result (``chars`` uint8[n, L], ``lens`` int32[n])."""
    chars = np.ascontiguousarray(chars, dtype=np.uint8)
    ascii_only = chars.size == 0 or int(chars.max()) < 0x80
    return CharTable(torch.from_numpy(chars).to(device),
                     torch.from_numpy(np.asarray(lens, np.int32).copy())
                     .to(device), ascii_only)


def char_table(scol) -> Optional[CharTable]:
    """The char table of a StringColumn's dictionary on the column's
    device, encoded once per dictionary and device (every batch of a
    scan shares it); None for an empty dictionary or one the encoder
    refuses."""
    from spark_rapids_tpu_torch.columnar.column import dictionary_cache

    cache = dictionary_cache(scol.dictionary)
    key = ("char_table", str(scol.device))
    if key not in cache:
        table = None
        if len(scol.dictionary):
            enc = encode_dictionary(scol.dictionary)
            if enc is not None:
                dev = scol.device
                table = CharTable(torch.from_numpy(enc[0]).to(dev),
                                  torch.from_numpy(enc[1]).to(dev), enc[2])
        cache[key] = table
    return cache[key]


# -- K4 ----------------------------------------------------------------------


def match_table_plain(chars: torch.Tensor, lens: torch.Tensor, kind: str,
                      needle: bytes) -> torch.Tensor:
    """The TPU kernel's arithmetic, for 1 <= m <= L: starts compares the
    first m bytes, ends the window at len - m, contains every window p
    with p + m <= len (one window at a time, so no (n, P, m) tensor)."""
    n, L = chars.shape
    m = len(needle)
    nd = torch.tensor(list(needle), dtype=torch.uint8, device=chars.device)
    lv = lens.to(torch.int64)
    if kind == "starts":
        return (chars[:, :m] == nd).all(1) & (lv >= m)
    if kind == "ends":
        cols = lv[:, None] - m + torch.arange(m, device=chars.device)
        w = torch.gather(chars, 1, cols.clamp(0, L - 1))
        return (w == nd).all(1) & (lv >= m)
    hit = torch.zeros(n, dtype=torch.bool, device=chars.device)
    for p in range(L - m + 1):
        hit |= (chars[:, p:p + m] == nd).all(1) & (lv >= p + m)
    return hit


def match_table(chars: torch.Tensor, lens: torch.Tensor, kind: str,
                needle: bytes) -> torch.Tensor:
    """bool[n]: does each entry start with / end with / contain
    ``needle`` (bytes; exact on UTF-8 for any input)."""
    if kind not in KINDS:
        raise ValueError(f"match_table: unknown kind {kind!r}")
    n, L = chars.shape
    m = len(needle)
    if m > L:  # longer than every entry: nothing matches
        return torch.zeros(n, dtype=torch.bool, device=chars.device)
    if m == 0:  # '' is a prefix, suffix and substring of everything
        return torch.ones(n, dtype=torch.bool, device=chars.device)
    if not chars.is_cuda:
        return match_table_plain(chars, lens, kind, needle)
    chars, lens = chars.contiguous(), lens.contiguous()
    nk.require_cuda("match_table", [chars, lens],
                    [torch.uint8, torch.int32])
    out = torch.empty(n, dtype=torch.bool, device=chars.device)
    if n == 0:
        return out
    if chars.data_ptr() % 16:  # the kernel reads rows 16 bytes at a time
        chars = chars.clone()
    lib = nk.load("strings")
    nk.check(lib.srt_k4_match_table(
        chars.data_ptr(), lens.data_ptr(), n, L, bytes(needle), m,
        KINDS[kind], out.data_ptr(), nk.stream_handle(chars.device)),
        "match_table")
    nk.count_launch("match_table", n)
    return out


# -- K5 ----------------------------------------------------------------------

#: one pattern token: a literal byte, or None for the one-byte wildcard
_Token = Optional[int]
#: how a segment is matched (the TPU kernel's three branches)
LIKE_PREFIX, LIKE_SUFFIX, LIKE_SEARCH = 0, 1, 2


class LikePattern(NamedTuple):
    """A parsed LIKE pattern: the ``%``-separated segments (each a list of
    tokens) and whether the first and last segments are anchored."""

    segments: List[List[_Token]]
    first_anchored: bool
    last_anchored: bool


def parse_like(pattern: str, escape: str) -> LikePattern:
    """The reference's ``_parse_like`` plus its anchoring pass: an escaped
    character is a literal (a lone trailing escape is itself a literal),
    ``%`` separates segments and ``_`` is a one-byte wildcard. Anchoring
    comes from the token stream, so an escaped trailing ``%`` anchors."""
    segments: List[List[_Token]] = [[]]
    starts_pct = ends_pct = False
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        pct = False
        if ch == escape and i + 1 < len(pattern):
            segments[-1].extend(pattern[i + 1].encode("utf-8"))
            i += 2
        else:
            if ch == "%":
                segments.append([])
                pct = True
            elif ch == "_":
                segments[-1].append(None)
            else:
                segments[-1].extend(ch.encode("utf-8"))
            i += 1
        starts_pct = starts_pct or (pct and i == 1)
        ends_pct = pct
    return LikePattern(segments, not starts_pct, not ends_pct)


def like_segments(lp: LikePattern) -> List[Tuple[int, List[_Token]]]:
    """(mode, tokens) of every non-empty segment, in order: the TPU
    kernel's branch for it (``LIKE_PREFIX``, ``LIKE_SUFFIX`` or
    ``LIKE_SEARCH``). Empty segments match anything and are skipped."""
    last = len(lp.segments) - 1
    out = []
    for si, seg in enumerate(lp.segments):
        if not seg:
            continue
        if si == 0 and lp.first_anchored:
            out.append((LIKE_PREFIX, seg))
        elif si == last and lp.last_anchored:
            out.append((LIKE_SUFFIX, seg))
        else:
            out.append((LIKE_SEARCH, seg))
    return out


def _exact_len(lp: LikePattern) -> Optional[int]:
    """The byte length an entry must have when the pattern has no ``%``."""
    if len(lp.segments) == 1 and lp.first_anchored and lp.last_anchored:
        return len(lp.segments[0])
    return None


def like_table_plain(chars: torch.Tensor, lens: torch.Tensor, pattern: str,
                     escape: str = "\\") -> torch.Tensor:
    """The TPU kernel's arithmetic, segment by segment: an anchored first
    segment compares bytes 0..m-1, an anchored last one the window at
    len - m (which must start at or after the cursor), any other segment
    takes its leftmost window at or after the cursor, one window at a
    time (no (n, P, m) tensor); a pattern without ``%`` also needs the
    exact length. ``_`` matches any one byte."""
    n, L = chars.shape
    dev = chars.device
    lp = like_spec(pattern, escape).pattern
    lv = lens.to(torch.int64)
    ok = torch.ones(n, dtype=torch.bool, device=dev)
    cur = torch.zeros(n, dtype=torch.int64, device=dev)
    for mode, seg in like_segments(lp):
        m = len(seg)
        if m > L:
            ok = torch.zeros_like(ok)
            break
        sv = torch.tensor([0 if t is None else t for t in seg],
                          dtype=torch.uint8, device=dev)
        wv = torch.tensor([t is None for t in seg], dtype=torch.bool,
                          device=dev)
        if mode == LIKE_PREFIX:
            w = (chars[:, :m] == sv) | wv
            ok = ok & w.all(1) & (lv >= m)
            cur = torch.full_like(cur, m)
        elif mode == LIKE_SUFFIX:
            cols = lv[:, None] - m + torch.arange(m, device=dev)
            w = (torch.gather(chars, 1, cols.clamp(0, L - 1)) == sv) | wv
            ok = ok & w.all(1) & (lv - m >= cur)
            cur = lv
        else:
            found = torch.zeros_like(ok)
            first = torch.zeros_like(cur)
            for p in range(L - m + 1):
                hit = ((chars[:, p:p + m] == sv) | wv).all(1) & \
                    (lv >= p + m) & (cur <= p) & ~found
                first = torch.where(hit, torch.full_like(first, p), first)
                found |= hit
            ok = ok & found
            cur = first + m
    exact = _exact_len(lp)
    if exact is not None:
        ok = ok & (lv == exact)
    return ok


class LikeSpec(NamedTuple):
    """A LIKE pattern as K5 takes it, parsed once per (pattern, escape):
    the non-empty segments' bytes concatenated (``body``), which of them
    are ``_`` (``wild``, one flag byte each), and the arguments of
    ``srt_k5_like_table`` that describe it (body, wild, their length, each
    segment's length and their count, the anchoring of the first and the
    last, the exact length a pattern without ``%`` needs or -1)."""

    pattern: LikePattern
    body: bytes
    wild: bytes
    args: tuple


@functools.lru_cache(maxsize=256)
def like_spec(pattern: str, escape: str) -> LikeSpec:
    lp = parse_like(pattern, escape)
    modes = like_segments(lp)
    tokens = [t for _, seg in modes for t in seg]
    body = bytes(0 if t is None else t for t in tokens)
    wild = bytes(int(t is None) for t in tokens)
    seg_lens = [len(seg) for _, seg in modes]
    exact = _exact_len(lp)
    args = (body, wild, len(body),
            (ctypes.c_int * max(len(seg_lens), 1))(*seg_lens), len(seg_lens),
            int(bool(modes) and modes[0][0] == LIKE_PREFIX),
            int(bool(modes) and modes[-1][0] == LIKE_SUFFIX),
            -1 if exact is None else exact)
    return LikeSpec(lp, body, wild, args)


def like_table(chars: torch.Tensor, lens: torch.Tensor, pattern: str,
               escape: str, ascii_only: bool) -> Optional[torch.Tensor]:
    """bool[n]: does each entry match the SQL LIKE ``pattern``; None where
    the reference declines too (``_`` over a non-ASCII table, where a
    byte is not a character), and the caller runs its host transform.
    A pattern whose literal bytes exceed L matches nothing (matched
    segments never overlap), so it launches nothing."""
    spec = like_spec(pattern, escape)
    if not ascii_only and any(spec.wild):
        return None
    n, L = chars.shape
    if len(spec.body) > L:
        return torch.zeros(n, dtype=torch.bool, device=chars.device)
    if not chars.is_cuda:
        return like_table_plain(chars, lens, pattern, escape)
    chars, lens = chars.contiguous(), lens.contiguous()
    nk.require_cuda("like_table", [chars, lens], [torch.uint8, torch.int32])
    out = torch.empty(n, dtype=torch.bool, device=chars.device)
    if n == 0:
        return out
    if chars.data_ptr() % 16:  # the kernel reads rows 16 bytes at a time
        chars = chars.clone()
    lib = nk.load("strings")
    nk.check(lib.srt_k5_like_table(
        chars.data_ptr(), lens.data_ptr(), n, L, *spec.args,
        out.data_ptr(), nk.stream_handle(chars.device)), "like_table")
    nk.count_launch("like_table", n)
    return out


# -- K6 ----------------------------------------------------------------------


def substring_table_plain(chars: torch.Tensor, lens: torch.Tensor, pos: int,
                          length: Optional[int]):
    """The TPU kernel's arithmetic: the slice's clamped bounds per entry,
    a gather along the row, zero padding past the new length."""
    n, L = chars.shape
    lv = lens.to(torch.int64)
    if pos > 0:
        start = torch.full_like(lv, pos - 1)
    elif pos < 0:
        start = lv + pos
    else:
        start = torch.zeros_like(lv)
    end = lv if length is None else start + length
    start_c = torch.minimum(start.clamp(min=0), lv)
    end_c = torch.minimum(end, lv).clamp(min=0)
    out_len = (end_c - start_c).clamp(min=0)
    j = torch.arange(L, device=chars.device)
    sliced = torch.gather(chars, 1, (start_c[:, None] + j).clamp(0, L - 1))
    keep = j[None, :] < out_len[:, None]
    return (torch.where(keep, sliced, torch.zeros_like(sliced)),
            out_len.to(torch.int32))


def substring_table(chars: torch.Tensor, lens: torch.Tensor, pos: int,
                    length: Optional[int]):
    """(chars uint8[n, L], lens int32[n]) of ``substring(entry, pos,
    length)`` for every entry of an ASCII table (byte == character);
    ``length`` None means to the end."""
    if not chars.is_cuda:
        return substring_table_plain(chars, lens, pos, length)
    chars, lens = chars.contiguous(), lens.contiguous()
    nk.require_cuda("substring", [chars, lens], [torch.uint8, torch.int32])
    n, L = chars.shape
    out = torch.empty_like(chars)
    out_lens = torch.empty_like(lens)
    if n == 0:
        return out, out_lens
    if chars.data_ptr() % 16:  # the kernel moves 16-byte chunks
        chars = chars.clone()
    lib = nk.load("strings")
    nk.check(lib.srt_k6_substring(
        chars.data_ptr(), lens.data_ptr(), n, L, int(pos),
        0 if length is None else int(length), int(length is not None),
        out.data_ptr(), out_lens.data_ptr(),
        nk.stream_handle(chars.device)), "substring")
    nk.count_launch("substring", n)
    return out, out_lens


def rebuild_dictionary(out_chars: torch.Tensor
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """(sorted dictionary of the sliced entries, code remap int32): the
    reference's ``np.unique(transformed.astype(str))``. The slices are
    ASCII and zero-padded, so the rows viewed as fixed-width bytes are
    the entries (trailing NULs dropped, as ``astype(str)`` drops them)."""
    oc = out_chars.cpu().numpy()
    n, L = oc.shape
    as_bytes = np.ascontiguousarray(oc).view(f"S{L}").reshape(n)
    new_dict, inv = np.unique(as_bytes, return_inverse=True)
    return new_dict.astype(f"U{L}").astype(object), \
        inv.reshape(n).astype(np.int32)


# -- expression routes -------------------------------------------------------


def gather_table(table: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Per-row values of a per-entry table (codes clipped into range,
    as the reference's ``take(mode="clip")``)."""
    return table[codes.to(torch.int64).clamp(0, table.shape[0] - 1)]


def predicate_colv(v, kind: str, needle: str, escape: str = "\\"):
    """The boolean ColV of a starts / ends / contains predicate over a
    dictionary column through K4, or of ``like`` (``needle`` the pattern)
    through K5; None when the column has no char table, or for a LIKE the
    kernel declines (the caller runs its host transform)."""
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.expressions.base import ColV

    table = None if v.scol is None else char_table(v.scol)
    if table is None:
        return None
    if kind == "like":
        hit = like_table(table.chars, table.lens, needle, escape,
                         table.ascii_only)
        if hit is None:
            return None
    else:
        hit = match_table(table.chars, table.lens, kind,
                          needle.encode("utf-8"))
    return ColV(dt.BOOLEAN, gather_table(hit, v.data), v.validity)


def substring_colv(v, pos: int, length: Optional[int]):
    """The string ColV of ``substring(v, pos, length)`` through K6 and
    a host rebuild of the dictionary, or None when the column has no
    char table or a non-ASCII one."""
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.columnar.column import StringColumn
    from spark_rapids_tpu_torch.expressions.base import ColV

    table = None if v.scol is None else char_table(v.scol)
    if table is None or not table.ascii_only:
        return None
    out_chars, _ = substring_table(table.chars, table.lens, pos, length)
    new_dict, remap = rebuild_dictionary(out_chars)
    codes = gather_table(torch.from_numpy(remap).to(v.data.device), v.data)
    sc = StringColumn(codes, new_dict, v.validity)
    return ColV(dt.STRING, codes, v.validity, sc)
