"""LZW decoding for the GIF and TIFF readers (utils/gif.py, utils/tiff.py).

The two formats share the algorithm and differ in how codes are packed:
GIF packs them least significant bit first and widens a code once the
table's next entry needs the extra bit (at 2^w entries); TIFF packs them
most significant bit first and widens one entry earlier (at 2^w - 1, the
"early change" of libtiff and of every TIFF writer since TIFF 6.0). Both
start at one bit above the literal size, stop growing at 12 bits, and keep
decoding at 12 bits with a full table until the next clear code (the
"deferred clear" of GIF; TIFF writers clear at the table's end).
"""

from __future__ import annotations


def lzw_decode(data, literal_bits: int, tiff: bool, limit: int, name: str) -> bytes:
    """The bytes that the LZW codes in `data` stand for, at most `limit` of
    them (decoding stops there, or at the end code, or at the end of the
    data). literal_bits: GIF's minimum code size (2-8), 8 for TIFF. tiff:
    the TIFF packing (MSB first, early change) instead of GIF's. A code
    that names no entry raises ValueError naming `name`."""
    clear = 1 << literal_bits
    end = clear + 1
    early = 1 if tiff else 0
    table = [bytes((i,)) for i in range(clear)] + [b"", b""]
    width = literal_bits + 1
    mask = (1 << width) - 1
    out = bytearray()
    prev = None
    buf = nbits = pos = 0
    n = len(data)
    while len(out) < limit:
        while nbits < width:
            if pos == n:
                return bytes(out)
            if tiff:
                buf = (buf << 8) | data[pos]
            else:
                buf |= data[pos] << nbits
            pos += 1
            nbits += 8
        nbits -= width
        if tiff:
            code = (buf >> nbits) & mask
            buf &= (1 << nbits) - 1
        else:
            code = buf & mask
            buf >>= width
        if code == clear:
            del table[clear + 2:]
            width = literal_bits + 1
            mask = (1 << width) - 1
            prev = None
            continue
        if code == end:
            break
        if prev is None:
            if code > clear:
                raise ValueError(f"{name}: LZW code {code} after a clear code names no entry")
            entry = table[code]
        else:
            size = len(table)
            if code < size:
                entry = table[code]
                added = prev + entry[:1]
            elif code == size:  # the entry being defined: prev + its own first byte
                entry = added = prev + prev[:1]
            else:
                raise ValueError(f"{name}: LZW code {code} beyond the table's {size} entries")
            if size < 4096:
                table.append(added)
                if size + 1 == (1 << width) - early and width < 12:
                    width += 1
                    mask = (1 << width) - 1
        out += entry
        prev = entry
    return bytes(out[:limit])
