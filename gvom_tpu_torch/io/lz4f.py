"""Pure-Python LZ4 frame codec for lz4-compressed rosbag chunks; the port's
copy of gvom_tpu/io/lz4f.py (the two give byte-identical frames).

RELLIS-era bags (the reference's data source, reference README.md:13-23) are
commonly recorded with `rosbag record --lz4`; ROS's roslz4 writes standard
LZ4 *frames* (magic 0x184D2204) as the chunk payload. The `lz4` pip package
is not a baked-in dependency here, so this module implements the subset the
bag reader needs from the published spec:

  * LZ4 block decompression (token / literals / offset / matchlen),
  * LZ4 frame parsing (FLG/BD descriptor, block stream, checksums),
  * xxHash32 (frame header + optional content/block checksum verification),
  * a compliant greedy hash-chain compressor (so `write_minimal_bag` can emit
    lz4 chunks and the round-trip is testable without ROS).

Format references: lz4 block + frame format specs (lz4.github.io/lz4).
"""

from __future__ import annotations

import struct

__all__ = ["decompress", "compress", "block_decompress", "block_compress", "xxh32"]

_MAGIC = 0x184D2204
_u32 = struct.Struct("<I")

# xxHash32 primes
_P1, _P2, _P3, _P4, _P5 = 2654435761, 2246822519, 3266489917, 668265263, 374761393
_M32 = 0xFFFFFFFF


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def xxh32(data: bytes, seed: int = 0) -> int:
    n = len(data)
    i = 0
    if n >= 16:
        v1 = (seed + _P1 + _P2) & _M32
        v2 = (seed + _P2) & _M32
        v3 = seed
        v4 = (seed - _P1) & _M32
        lim = n - 16
        while i <= lim:
            a, b, c, d = struct.unpack_from("<4I", data, i)
            v1 = (_rotl((v1 + a * _P2) & _M32, 13) * _P1) & _M32
            v2 = (_rotl((v2 + b * _P2) & _M32, 13) * _P1) & _M32
            v3 = (_rotl((v3 + c * _P2) & _M32, 13) * _P1) & _M32
            v4 = (_rotl((v4 + d * _P2) & _M32, 13) * _P1) & _M32
            i += 16
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M32
    else:
        h = (seed + _P5) & _M32
    h = (h + n) & _M32
    while i + 4 <= n:
        (k,) = _u32.unpack_from(data, i)
        h = (_rotl((h + k * _P3) & _M32, 17) * _P4) & _M32
        i += 4
    while i < n:
        h = (_rotl((h + data[i] * _P5) & _M32, 11) * _P1) & _M32
        i += 1
    h ^= h >> 15
    h = (h * _P2) & _M32
    h ^= h >> 13
    h = (h * _P3) & _M32
    h ^= h >> 16
    return h


# ----------------------------------------------------------------------
# block format


def block_decompress(src: bytes, max_size: int = 1 << 30, history: bytes = b"") -> bytes:
    """One raw LZ4 block → bytes. max_size bounds the output (corruption
    guard; a bag chunk is well under 1 GB). `history` is the preceding
    decoded frame output for linked-block frames (FLG bit 5 clear — the
    default for python-lz4 / the lz4 CLI): match offsets may reach back into
    it. Independent blocks (roslz4's bag chunks) pass no history."""
    dst = bytearray()
    h = len(history)
    i, n = 0, len(src)
    while i < n:
        token = src[i]
        i += 1
        litlen = token >> 4
        if litlen == 15:
            while True:
                if i >= n:
                    raise ValueError("lz4: truncated literal length")
                b = src[i]
                i += 1
                litlen += b
                if b != 255:
                    break
        if i + litlen > n:
            raise ValueError("lz4: literal run past end of block")
        dst += src[i : i + litlen]
        i += litlen
        if i == n:
            break                      # last sequence carries no match
        if len(dst) > max_size:
            raise ValueError("lz4: output exceeds max_size")
        if i + 2 > n:
            raise ValueError("lz4: truncated match offset")
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        if offset == 0 or offset > len(dst) + h:
            raise ValueError("lz4: invalid match offset")
        mlen = token & 0xF
        if mlen == 15:
            while True:
                if i >= n:
                    raise ValueError("lz4: truncated match length")
                b = src[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        mlen += 4
        start = len(dst) - offset
        if start >= 0 and offset >= mlen:
            dst += dst[start : start + mlen]
        else:
            # overlapping match (source grows as we write) and/or a
            # linked-block match reaching back into the frame history
            for k in range(mlen):
                s = start + k
                dst.append(dst[s] if s >= 0 else history[h + s])
        if len(dst) > max_size:
            raise ValueError("lz4: output exceeds max_size")
    return bytes(dst)


def _write_lsic(out: bytearray, v: int) -> None:
    while v >= 255:
        out.append(255)
        v -= 255
    out.append(v)


def block_compress(src: bytes) -> bytes:
    """Greedy hash-table LZ4 block compressor (spec-compliant: min match 4,
    last match ends ≥ 12 bytes before block end, final sequence literal-only)."""
    n = len(src)
    out = bytearray()
    table: dict = {}
    anchor = 0
    i = 0
    limit = n - 12                      # matches must not start past here
    while i <= limit:
        key = src[i : i + 4]
        j = table.get(key, -1)
        table[key] = i
        if j >= 0 and i - j <= 0xFFFF and src[j : j + 4] == key:
            # extend match (must end ≥ 5 bytes before block end)
            end = n - 5
            m = i + 4
            k = j + 4
            while m < end and src[m] == src[k]:
                m += 1
                k += 1
            litlen = i - anchor
            mlen = m - i - 4
            token = (min(litlen, 15) << 4) | min(mlen, 15)
            out.append(token)
            if litlen >= 15:
                _write_lsic(out, litlen - 15)
            out += src[anchor:i]
            out += struct.pack("<H", i - j)
            if mlen >= 15:
                _write_lsic(out, mlen - 15)
            anchor = m
            i = m
        else:
            i += 1
    # final literal-only sequence
    litlen = n - anchor
    out.append(min(litlen, 15) << 4)
    if litlen >= 15:
        _write_lsic(out, litlen - 15)
    out += src[anchor:]
    return bytes(out)


# ----------------------------------------------------------------------
# frame format

_BD_SIZES = {4: 1 << 16, 5: 1 << 18, 6: 1 << 20, 7: 1 << 22}


def decompress(data: bytes, verify_checksums: bool = True) -> bytes:
    """LZ4 frame(s) → bytes. Concatenated frames and skippable frames are
    handled; block/content checksums are verified unless told not to."""
    out = bytearray()
    off = 0
    n = len(data)
    while off + 4 <= n:
        (magic,) = _u32.unpack_from(data, off)
        off += 4
        if (magic & 0xFFFFFFF0) == 0x184D2A50:      # skippable frame
            (sz,) = _u32.unpack_from(data, off)
            off += 4 + sz
            continue
        if magic != _MAGIC:
            raise ValueError(f"lz4: bad frame magic 0x{magic:08x}")
        flg = data[off]
        bd = data[off + 1]
        off += 2
        version = flg >> 6
        if version != 1:
            raise ValueError(f"lz4: unsupported frame version {version}")
        b_independent = bool(flg & 0x20)
        b_checksum = bool(flg & 0x10)
        c_size = bool(flg & 0x08)
        c_checksum = bool(flg & 0x04)
        dict_id = bool(flg & 0x01)
        desc_start = off - 2
        if c_size:
            off += 8
        if dict_id:
            off += 4
        hc = data[off]
        off += 1
        if verify_checksums:
            want = (xxh32(data[desc_start:off - 1]) >> 8) & 0xFF
            if hc != want:
                raise ValueError("lz4: frame descriptor checksum mismatch")
        if (bd >> 4) & 0x7 not in _BD_SIZES:
            raise ValueError(f"lz4: invalid block max-size id {(bd >> 4) & 0x7}")
        frame_out_start = len(out)
        while True:
            (bsize,) = _u32.unpack_from(data, off)
            off += 4
            if bsize == 0:              # EndMark
                break
            uncompressed = bool(bsize & 0x80000000)
            bsize &= 0x7FFFFFFF
            blk = data[off : off + bsize]
            off += bsize
            if b_checksum:
                (bc,) = _u32.unpack_from(data, off)
                off += 4
                if verify_checksums and xxh32(blk) != bc:
                    raise ValueError("lz4: block checksum mismatch")
            if uncompressed:
                out += blk
            else:
                # linked-block frames (FLG bit 5 clear): matches may reach
                # up to 64 KB into the frame's previously decoded output
                hist = b"" if b_independent else bytes(out[max(frame_out_start, len(out) - 65536):])
                out += block_decompress(blk, history=hist)
        if c_checksum:
            (cc,) = _u32.unpack_from(data, off)
            off += 4
            if verify_checksums and xxh32(bytes(out[frame_out_start:])) != cc:
                raise ValueError("lz4: content checksum mismatch")
    return bytes(out)


def compress(data: bytes, block_size_id: int = 7, content_checksum: bool = True) -> bytes:
    """bytes → one LZ4 frame (block-independent, roslz4-compatible layout)."""
    if block_size_id not in _BD_SIZES:
        raise ValueError(f"lz4: invalid block max-size id {block_size_id}")
    bmax = _BD_SIZES[block_size_id]
    flg = (1 << 6) | (1 << 5) | ((1 << 2) if content_checksum else 0)  # v1, indep
    bd = block_size_id << 4
    desc = bytes([flg, bd])
    hc = (xxh32(desc) >> 8) & 0xFF
    out = bytearray(_u32.pack(_MAGIC) + desc + bytes([hc]))
    for i in range(0, len(data), bmax):
        blk = data[i : i + bmax]
        comp = block_compress(blk)
        if len(comp) < len(blk):
            out += _u32.pack(len(comp)) + comp
        else:
            out += _u32.pack(len(blk) | 0x80000000) + blk
    out += _u32.pack(0)                 # EndMark (empty payload: no blocks)
    if content_checksum:
        out += _u32.pack(xxh32(data))
    return bytes(out)
