"""Minimal standalone FITS reader/writer (no astropy dependency).

The reference delegates FITS parsing to ``astropy.io.fits`` (used at
``spectral_cube/io/fits.py:63-168``).  This module implements
the subset of the FITS standard a spectral-cube engine needs:

- header parsing/formatting (80-char cards, 2880-byte blocks, strings,
  logicals, ints, floats, COMMENT/HISTORY, END),
- primary + extension image HDUs with BITPIX 8/16/32/64/-32/-64,
  BSCALE/BZERO, memory-mapped lazy data access,
- binary tables (enough to round-trip the per-channel BEAMS table:
  TFORM codes L, B, I, J, K, E, D and fixed-length arrays thereof).

Data are returned as numpy arrays in native byte order.
"""

from __future__ import annotations

import os
import re
import warnings
from collections import OrderedDict

import numpy as np

__all__ = ["Header", "HDU", "BinTableHDU", "read_fits", "write_fits",
           "is_fits"]

BLOCK = 2880
CARD = 80

_BITPIX_DTYPE = {8: ">u1", 16: ">i2", 32: ">i4", 64: ">i8",
                 -32: ">f4", -64: ">f8"}
_DTYPE_BITPIX = {"uint8": 8, "int16": 16, "int32": 32, "int64": 64,
                 "float32": -32, "float64": -64}

_TFORM_DTYPE = {"L": ">u1", "B": ">u1", "I": ">i2", "J": ">i4", "K": ">i8",
                "E": ">f4", "D": ">f8", "A": "S"}


class Header:
    """An ordered FITS header: keyword -> value, with comments.

    COMMENT/HISTORY cards accumulate in lists. Dict-like access
    (``h['NAXIS']``, ``h.get``, ``in``) mirrors astropy Header usage in the
    reference."""

    def __init__(self, cards=None):
        self._cards = OrderedDict()
        self._comments = {}
        self.comments_log: list[str] = []
        self.history: list[str] = []
        if cards:
            if isinstance(cards, Header):
                self._cards = OrderedDict(cards._cards)
                self._comments = dict(cards._comments)
                self.comments_log = list(cards.comments_log)
                self.history = list(cards.history)
            elif isinstance(cards, dict):
                for k, v in cards.items():
                    self[k] = v
            else:
                for k, v in cards:
                    self[k] = v

    def __getitem__(self, key):
        k = key.upper()
        if k == "COMMENT":
            return list(self.comments_log)
        if k == "HISTORY":
            return list(self.history)
        return self._cards[k]

    def __setitem__(self, key, value):
        comment = None
        if isinstance(value, tuple) and len(value) == 2:
            value, comment = value
        key = key.upper()
        if key == "COMMENT":
            self.comments_log.append(str(value))
            return
        if key == "HISTORY":
            self.history.append(str(value))
            return
        self._cards[key] = value
        if comment is not None:
            self._comments[key] = comment

    def __delitem__(self, key):
        del self._cards[key.upper()]
        self._comments.pop(key.upper(), None)

    def __contains__(self, key):
        k = key.upper()
        if k == "COMMENT":
            return bool(self.comments_log)
        if k == "HISTORY":
            return bool(self.history)
        return k in self._cards

    def __iter__(self):
        return iter(self._cards)

    def __len__(self):
        return len(self._cards)

    def get(self, key, default=None):
        k = key.upper()
        if k in ("COMMENT", "HISTORY"):
            return self[k] if k in self else default
        return self._cards.get(k, default)

    def pop(self, key, *default):
        self._comments.pop(key.upper(), None)
        return self._cards.pop(key.upper(), *default)

    def keys(self):
        return self._cards.keys()

    def items(self):
        return self._cards.items()

    def update(self, other):
        if isinstance(other, Header):
            for k, v in other.items():
                self[k] = v
            for h in other.history:
                self.add_history(h)
        else:
            for k, v in dict(other).items():
                self[k] = v

    def copy(self):
        return Header(self)

    def add_history(self, text):
        # idempotent: re-writing a cube must not accumulate duplicate
        # provenance cards (repeated round-trips grew the header without
        # bound)
        if str(text) not in self.history:
            self.history.append(str(text))

    def add_comment(self, text):
        self.comments_log.append(str(text))

    def comment(self, key):
        return self._comments.get(key.upper(), "")

    def __repr__(self):
        return "\n".join(f"{k:8s}= {v!r}" for k, v in self._cards.items())


def fold_meta_into_header(header, meta, wcsheader=()):
    """Copy metadata dict entries into a Header before the WCS cards are
    applied, so WCS formatting wins on collision (reference
    base_class.py:80-93): string keys <= 8 chars become cards (value
    stringified), longer keys become ``key=value`` COMMENT lines."""
    for key in (meta or {}):
        if not isinstance(key, str) or key.upper() in wcsheader:
            continue
        if len(key) <= 8:
            try:
                header[key.upper()] = str(meta[key])
            except ValueError:
                pass
        else:
            header.add_comment(f"{key}={meta[key]}")


_string_re = re.compile(r"^'((?:[^']|'')*)'\s*(?:/\s?(.*))?$")
_value_re = re.compile(r"^([^/]*?)\s*(?:/\s?(.*))?$")


def _parse_card(card: str):
    key = card[:8].strip().upper()
    if key in ("", "END"):
        return key, None, None
    if key in ("COMMENT", "HISTORY") or card[8:10] != "= ":
        return key, card[8:].strip(), None
    rest = card[10:]
    m = _string_re.match(rest.strip())
    if m:
        return key, m.group(1).replace("''", "'").rstrip(), m.group(2)
    m = _value_re.match(rest)
    raw = m.group(1).strip() if m else rest.strip()
    comment = m.group(2) if m else None
    if raw in ("T", "F"):
        return key, raw == "T", comment
    if raw == "":
        return key, None, comment
    try:
        if re.fullmatch(r"[+-]?\d+", raw):
            return key, int(raw), comment
        return key, float(raw.replace("D", "E").replace("d", "e")), comment
    except ValueError:
        return key, raw, comment


def _format_value(value) -> str:
    if isinstance(value, bool):
        return "T" if value else "F"
    if isinstance(value, (int, np.integer)):
        return f"{int(value):>20d}"
    if isinstance(value, (float, np.floating)):
        # full double precision like astropy (a .14G float silently
        # corrupted BMAJ/CRVAL round-trips at the 1e-14 level); shortest
        # repr that round-trips, squeezed into the 20-char field
        v = float(value)
        s = repr(v).upper()
        if len(s) > 20:
            # shortest exact scientific form; FITS free-format permits
            # values extending past column 30, so never truncate digits
            s2 = f"{v:.17E}".upper()
            mant, _, exp = s2.partition("E")
            mant = mant.rstrip("0").rstrip(".")
            s2 = f"{mant}E{int(exp):+03d}"
            if float(s2) == v and len(s2) < len(s):
                s = s2
        if "." not in s and "E" not in s and "N" not in s:
            s += ".0"
        return f"{s:>20s}"
    if value is None:
        return ""
    s = str(value).replace("'", "''")
    return f"'{s:<8s}'"


def _format_long_string_cards(key, s, comment=None) -> str:
    """FITS long-string (OGIP 1.0 CONTINUE) convention: the value is
    split over a KEY card plus CONTINUE cards, each chunk but the last
    ending with '&' inside the quotes."""
    chunks, cur, cur_len = [], "", 0
    for ch in s:
        el = 2 if ch == "'" else 1       # quotes escape to ''
        if cur_len + el > 66:            # leave room for the '&'
            chunks.append(cur)
            cur, cur_len = "", 0
        cur += ch
        cur_len += el
    chunks.append(cur)
    cards = []
    for i, c in enumerate(chunks):
        esc = c.replace("'", "''")
        last = i == len(chunks) - 1
        head = f"{key[:8]:<8s}= " if i == 0 else "CONTINUE  "
        card = head + f"'{esc}{'' if last else '&'}'"
        if last and comment and len(card) + 3 + len(comment) <= CARD:
            card += f" / {comment}"
        cards.append(card[:CARD].ljust(CARD))
    return "".join(cards)


def _format_card(key, value, comment=None) -> str:
    if key in ("COMMENT", "HISTORY"):
        card = f"{key:<8s}{str(value)[:72]}"
    else:
        if isinstance(value, str) and \
                len(value.replace("'", "''")) > 68:
            return _format_long_string_cards(key, value, comment)
        vs = _format_value(value)
        card = f"{key[:8]:<8s}= {vs}"
        if comment:
            card += f" / {comment}"
    return card[:CARD].ljust(CARD)


def parse_header(block_bytes: bytes) -> Header:
    h = Header()
    text = block_bytes.decode("ascii", errors="replace")
    last_key = None
    for i in range(0, len(text), CARD):
        card = text[i:i + CARD]
        key, value, comment = _parse_card(card)
        if key == "END":
            break
        if key == "":
            continue
        if key == "COMMENT":
            h.comments_log.append(value or "")
        elif key == "HISTORY":
            h.history.append(value or "")
        elif key == "CONTINUE":
            # long-string convention: append to the previous card's
            # value, dropping its trailing '&'
            m = _string_re.match(card[8:].strip())
            prev = h._cards.get(last_key) if last_key else None
            if m and isinstance(prev, str) and prev.endswith("&"):
                h._cards[last_key] = \
                    prev[:-1] + m.group(1).replace("''", "'").rstrip()
                if m.group(2):
                    h._comments[last_key] = m.group(2)
        else:
            h._cards[key] = value
            last_key = key
            if comment:
                h._comments[key] = comment
    return h


def format_header(h: Header) -> bytes:
    cards = []
    # canonical ordering: SIMPLE/XTENSION, BITPIX, NAXIS, NAXISn first
    order_first = ["SIMPLE", "XTENSION", "BITPIX", "NAXIS"]
    order_first += [k for k in h.keys() if re.fullmatch(r"NAXIS\d+", k)]
    seen = set()
    for k in order_first:
        if k in h and k not in seen:
            cards.append(_format_card(k, h[k], h.comment(k)))
            seen.add(k)
    for k, v in h.items():
        if k in seen:
            continue
        cards.append(_format_card(k, v, h.comment(k)))
    for line in h.comments_log:
        cards.append(_format_card("COMMENT", line))
    for line in h.history:
        cards.append(_format_card("HISTORY", line))
    cards.append("END".ljust(CARD))
    text = "".join(cards)
    pad = (-len(text)) % BLOCK
    return (text + " " * pad).encode("ascii")


class HDU:
    """An image HDU with lazily-loaded, optionally memmapped data."""

    def __init__(self, data=None, header=None, name=None):
        self.header = header if header is not None else Header()
        self._data = data
        self._lazy = None  # (path, offset, dtype, shape, bscale, bzero)
        self.name = name or self.header.get("EXTNAME", "")

    @property
    def shape(self):
        if self._data is not None:
            return self._data.shape
        if self._lazy is not None:
            return self._lazy[3]
        n = int(self.header.get("NAXIS", 0))
        return tuple(int(self.header[f"NAXIS{i}"])
                     for i in range(n, 0, -1))

    @property
    def data(self):
        if self._data is None and self._lazy is not None:
            path, offset, dtype, shape, bscale, bzero = self._lazy
            count = int(np.prod(shape)) if shape else 0
            if dtype.kind == "f" or bscale != 1.0 or bzero != 0.0:
                # fused multithreaded mmap+byteswap+scale decode (native
                # C++ when available, numpy fallback inside)
                from .native import decode_payload
                bitpix = {"u1": 8, "i2": 16, "i4": 32, "i8": 64,
                          "f4": -32, "f8": -64}[dtype.str[1:]]
                # scaled 32/64-bit integers promote to float64 (astropy
                # behavior): the unsigned convention BZERO=2**31 would
                # lose up to +-128 counts in float32
                out_dtype = np.float64 if bitpix in (-64, 32, 64) \
                    else np.float32
                if dtype.kind == "i" and bscale == 1.0 and bzero == 0.0:
                    out_dtype = None
                arr = decode_payload(path, offset, count, bitpix,
                                     bscale, bzero,
                                     out_dtype=out_dtype).reshape(shape)
            else:
                raw = np.memmap(path, dtype=dtype, mode="r", offset=offset,
                                shape=(count,))
                arr = np.asarray(raw).reshape(shape)
                arr = arr.astype(arr.dtype.newbyteorder("="), copy=False)
            self._data = arr
        return self._data

    def memmap_data(self):
        """Raw big-endian memmap without scaling (zero-copy lazy access)."""
        if self._lazy is None:
            return self.data
        path, offset, dtype, shape, bscale, bzero = self._lazy
        count = int(np.prod(shape)) if shape else 0
        return np.memmap(path, dtype=dtype, mode="r", offset=offset,
                         shape=shape)

    @property
    def is_image(self):
        xt = str(self.header.get("XTENSION", "IMAGE")).strip().upper()
        return xt == "IMAGE"


class BinTableHDU:
    """A binary table HDU: column-name -> numpy array."""

    def __init__(self, columns=None, header=None, name=None, units=None):
        self.header = header if header is not None else Header()
        self.columns = columns if columns is not None else OrderedDict()
        self.name = name or self.header.get("EXTNAME", "")
        self.units = units or {}

    def __getitem__(self, col):
        return self.columns[col]

    def __contains__(self, col):
        return col in self.columns

    @property
    def is_image(self):
        return False

    @property
    def nrows(self):
        if not self.columns:
            return 0
        return len(next(iter(self.columns.values())))


def _parse_tform(tform: str):
    m = re.fullmatch(r"(\d*)([LXBIJKAEDCMPQ])(.*)", tform.strip())
    if not m:
        raise ValueError(f"unsupported TFORM {tform!r}")
    repeat = int(m.group(1)) if m.group(1) else 1
    code = m.group(2)
    if code not in _TFORM_DTYPE:
        raise ValueError(f"unsupported TFORM code {code!r}")
    return repeat, code


def _read_bintable(header: Header, buf: bytes) -> BinTableHDU:
    nrows = int(header["NAXIS2"])
    rowlen = int(header["NAXIS1"])
    tfields = int(header["TFIELDS"])
    names, dtypes, units = [], [], {}
    for i in range(1, tfields + 1):
        name = str(header.get(f"TTYPE{i}", f"COL{i}")).strip()
        repeat, code = _parse_tform(str(header[f"TFORM{i}"]))
        if code == "A":
            dt = (name, f"S{repeat}")
        elif code == "L":
            dt = (name, _TFORM_DTYPE[code], (repeat,)) if repeat > 1 \
                else (name, _TFORM_DTYPE[code])
        else:
            dt = (name, _TFORM_DTYPE[code], (repeat,)) if repeat > 1 \
                else (name, _TFORM_DTYPE[code])
        names.append(name)
        dtypes.append(dt)
        if f"TUNIT{i}" in header:
            units[name] = str(header[f"TUNIT{i}"]).strip()
    dtype = np.dtype(dtypes)
    if dtype.itemsize != rowlen:
        # Rebuild with explicit offsets and itemsize=NAXIS1 so the row
        # stride is always right even when the heap/extra columns are not
        # modeled; raise if the modeled fields overrun the row.
        if dtype.itemsize > rowlen:
            raise ValueError(
                f"BINTABLE row model ({dtype.itemsize} bytes) overruns "
                f"NAXIS1={rowlen}; TFORM parsing mismatch")
        fmt_names, formats, offsets = [], [], []
        off = 0
        for dt in dtypes:
            fmt_names.append(dt[0])
            fmt = dt[1] if len(dt) == 2 else (dt[1], dt[2])
            formats.append(fmt)
            offsets.append(off)
            off += np.dtype(fmt).itemsize
        dtype = np.dtype({"names": fmt_names, "formats": formats,
                          "offsets": offsets, "itemsize": rowlen})
    rec = np.frombuffer(buf[:nrows * dtype.itemsize], dtype=dtype)
    cols = OrderedDict()
    logical = {str(header.get(f"TTYPE{i}", f"COL{i}")).strip()
               for i in range(1, tfields + 1)
               if _parse_tform(str(header[f"TFORM{i}"]))[1] == "L"}
    for name in names:
        col = rec[name]
        if name in logical:
            col = col == ord("T")  # FITS logical stores ASCII 'T'/'F'
        elif col.dtype.kind in "iuf":
            col = col.astype(col.dtype.newbyteorder("="))
        cols[name] = col
    return BinTableHDU(columns=cols, header=header, units=units)


def is_fits(path_or_bytes) -> bool:
    try:
        if isinstance(path_or_bytes, (bytes, bytearray)):
            head = bytes(path_or_bytes[:6])
        else:
            name = str(path_or_bytes)
            if not os.path.exists(name):
                return name.lower().endswith((".fits", ".fit", ".fits.gz"))
            with open(name, "rb") as f:
                head = f.read(6)
        return head.startswith(b"SIMPLE")
    except Exception:
        return False


def read_fits(path, memmap=True) -> list:
    """Read all HDUs from a FITS file. Image data loads lazily."""
    hdus = []
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        while f.tell() < size:
            # read header blocks until END card
            header_bytes = b""
            while True:
                block = f.read(BLOCK)
                if len(block) < BLOCK:
                    if not header_bytes:
                        return hdus
                    raise IOError("truncated FITS header")
                header_bytes += block
                text = block.decode("ascii", errors="replace")
                if any(text[i:i + 8].rstrip() == "END"
                       for i in range(0, BLOCK, CARD)):
                    break
            header = parse_header(header_bytes)
            naxis = int(header.get("NAXIS", 0))
            shape = tuple(int(header[f"NAXIS{i}"])
                          for i in range(naxis, 0, -1))
            bitpix = int(header.get("BITPIX", 8))
            xtension = str(header.get("XTENSION", "IMAGE")).strip().upper()
            nbytes = abs(bitpix) // 8 * int(np.prod(shape)) if naxis else 0
            if xtension == "BINTABLE":
                tbytes = int(header["NAXIS1"]) * int(header["NAXIS2"])
                nbytes = tbytes + int(header.get("PCOUNT", 0))
                buf = f.read(nbytes)
                from .tile_compress import (is_compressed_image,
                                            decompress_image_hdu)
                if is_compressed_image(header):
                    # FITS Tiled Image Compression convention: decode the
                    # RICE_1/GZIP tiles into a plain image HDU (the
                    # reference gets this through astropy CompImageHDU,
                    # reference io/fits.py:76-81); unsupported codecs
                    # raise FITSReadError (propagates past the
                    # unreadable-BINTABLE warning below)
                    theap = int(header.get("THEAP", tbytes))
                    img_hdr, data = decompress_image_hdu(
                        header, buf[:tbytes], buf[theap:])
                    hdus.append(HDU(header=Header(img_hdr), data=data))
                    pad = (-f.tell()) % BLOCK
                    f.seek(pad, 1)
                    continue
                try:
                    hdus.append(_read_bintable(header, buf))
                except (ValueError, KeyError) as exc:
                    # an auxiliary table with an unsupported TFORM (e.g.
                    # a variable-length provenance array) must not abort
                    # loading the image HDU and the BEAMS table
                    import warnings
                    warnings.warn(
                        f"skipping unreadable BINTABLE "
                        f"{header.get('EXTNAME', '?')!r}: {exc}")
            else:
                offset = f.tell()
                if naxis and nbytes:
                    hdu = HDU(header=header)
                    bscale = float(header.get("BSCALE", 1.0))
                    bzero = float(header.get("BZERO", 0.0))
                    hdu._lazy = (path, offset, np.dtype(_BITPIX_DTYPE[bitpix]),
                                 shape, bscale, bzero)
                    if not memmap:
                        hdu.data  # force load
                        hdu._lazy = None
                    hdus.append(hdu)
                    f.seek(offset + nbytes)
                else:
                    hdus.append(HDU(header=header, data=None))
            # skip padding
            pad = (-f.tell()) % BLOCK
            f.seek(pad, 1)
    return hdus


#: bytes of an image payload converted to the file's big-endian type at once
WRITE_CHUNK = 1 << 26


def _image_payload(data: np.ndarray):
    """``(bitpix, values, dtype)``: the FITS BITPIX of ``data``, its values
    flat in C order (a view of C-contiguous data) and the big-endian type
    they are written as (bool as uint8, other types as float64)."""
    dt = data.dtype
    if dt.kind == "b":
        data = data.astype(np.uint8)
        dt = data.dtype
    key = dt.name
    if key not in _DTYPE_BITPIX:
        data = data.astype(np.float64)
        key = "float64"
    bitpix = _DTYPE_BITPIX[key]
    return bitpix, data.reshape(-1), np.dtype(_BITPIX_DTYPE[bitpix])


def _write_payload(f, flat, dtype):
    """Write ``flat`` as ``dtype``, :data:`WRITE_CHUNK` bytes converted at
    a time, so that the host holds no whole-payload copy.  Returns the
    bytes written."""
    step = max(1, WRITE_CHUNK // dtype.itemsize)
    for i in range(0, flat.size, step):
        f.write(flat[i:i + step].astype(dtype))
    return flat.size * dtype.itemsize


def write_fits(path, hdus, compress=None):
    """Write a list of HDU/BinTableHDU to ``path``.

    ``compress``: None, or 'RICE_1'/'GZIP_1'/'GZIP_2' to store image HDUs
    through the Tiled Image Compression convention (integer data
    lossless via RICE; float data falls back to lossless GZIP of the raw
    pixels — no lossy quantization is ever applied)."""
    with open(path, "wb") as f:
        for idx, hdu in enumerate(hdus):
            h = Header(hdu.header)
            if isinstance(hdu, BinTableHDU):
                _write_bintable(f, hdu, h)
                continue
            data = hdu._data if hdu._data is not None else (
                hdu.data if hdu._lazy is not None else None)
            if compress is not None and data is not None:
                from .tile_compress import compressed_image_blocks
                if idx == 0:
                    # a compressed HDU is always an extension: emit a
                    # minimal empty primary first
                    ph = Header()
                    ph["SIMPLE"] = True
                    ph["BITPIX"] = 8
                    ph["NAXIS"] = 0
                    ph["EXTEND"] = True
                    f.write(format_header(ph))
                chdr, payload = compressed_image_blocks(
                    np.asarray(data), header=h, cmptype=compress)
                f.write(format_header(Header(chdr)))
                f.write(payload)
                f.write(b"\x00" * ((-len(payload)) % BLOCK))
                continue
            if idx == 0:
                h["SIMPLE"] = True
            else:
                h["XTENSION"] = "IMAGE"
                h["PCOUNT"] = 0
                h["GCOUNT"] = 1
            flat = None
            if data is not None:
                data = np.asarray(data)
                bitpix, flat, dtype = _image_payload(data)
                h["BITPIX"] = bitpix
                h["NAXIS"] = data.ndim
                for i, n in enumerate(data.shape[::-1]):
                    h[f"NAXIS{i + 1}"] = int(n)
                # a float payload holds DECODED values; stale scaling
                # cards from a scaled source would be re-applied on
                # read-back (raw integer payloads keep their cards —
                # astropy's passthrough semantics)
                if data.dtype.kind == "f":
                    for k in ("BSCALE", "BZERO", "BLANK"):
                        if k in h:
                            del h[k]
            else:
                h["BITPIX"] = 8
                h["NAXIS"] = 0
            f.write(format_header(h))
            n = 0 if flat is None else _write_payload(f, flat, dtype)
            f.write(b"\x00" * ((-n) % BLOCK))


_COL_TFORM = {"float32": "E", "float64": "D", "int16": "I", "int32": "J",
              "int64": "K", "uint8": "B", "bool": "L"}


def _write_bintable(f, hdu: BinTableHDU, h: Header):
    cols = hdu.columns
    names = list(cols.keys())
    dtypes = []
    for name in names:
        arr = np.asarray(cols[name])
        sub = arr.shape[1:] if arr.ndim > 1 else ()
        if arr.dtype.kind == "S":
            dtypes.append((name, arr.dtype, sub) if sub
                          else (name, arr.dtype))
        else:
            code = _COL_TFORM[arr.dtype.name]
            base = np.dtype(_TFORM_DTYPE[code])
            dtypes.append((name, base, sub) if sub else (name, base))
    rec_dtype = np.dtype(dtypes)
    nrows = len(np.asarray(cols[names[0]]))
    rec = np.zeros(nrows, dtype=rec_dtype)
    for name in names:
        arr = np.asarray(cols[name])
        if arr.dtype.kind == "b":
            # FITS logical stores ASCII 'T'/'F'
            arr = np.where(arr, ord("T"), ord("F")).astype(np.uint8)
        rec[name] = arr
    h["XTENSION"] = "BINTABLE"
    h["BITPIX"] = 8
    h["NAXIS"] = 2
    h["NAXIS1"] = rec_dtype.itemsize
    h["NAXIS2"] = nrows
    h["PCOUNT"] = 0
    h["GCOUNT"] = 1
    h["TFIELDS"] = len(names)
    for i, name in enumerate(names, start=1):
        arr = np.asarray(cols[name])
        h[f"TTYPE{i}"] = name
        rep = int(np.prod(arr.shape[1:])) if arr.ndim > 1 else 1
        if arr.dtype.kind == "S":
            h[f"TFORM{i}"] = f"{rep * arr.dtype.itemsize}A" if rep > 1 \
                else f"{arr.dtype.itemsize}A"
        else:
            code = _COL_TFORM[arr.dtype.name]
            h[f"TFORM{i}"] = f"{rep}{code}" if rep > 1 else code
        if name in hdu.units:
            h[f"TUNIT{i}"] = hdu.units[name]
    if hdu.name:
        h["EXTNAME"] = hdu.name
    f.write(format_header(h))
    payload = rec.tobytes()
    f.write(payload)
    f.write(b"\x00" * ((-len(payload)) % BLOCK))
