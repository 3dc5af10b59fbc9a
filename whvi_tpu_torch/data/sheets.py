"""Minimal dependency-free spreadsheet readers (numeric tables only).

The port's own copy of :mod:`whvi_tpu.data.sheets` (stdlib and numpy).
The reference loads its bundled UCI datasets with pandas and
xlrd/openpyxl; these small readers cover the two formats the experiments
need:

- :func:`read_xlsx_numeric` — .xlsx is a zip of XML; reads the first
  worksheet's numeric cells (string cells are skipped).
- :func:`read_xls_numeric` — legacy .xls (OLE2 compound file + BIFF8
  records); extracts NUMBER/RK/MULRK numeric cells from the Workbook
  stream.

Both return a dense float64 array of the numeric region with NaN for
non-numeric cells, rows and columns with no number dropped.
"""

from __future__ import annotations

import re
import struct
import zipfile
from xml.etree import ElementTree

import numpy as np

__all__ = ["read_xlsx_numeric", "read_xls_numeric"]


def _cells_to_array(cells: dict[tuple[int, int], float]) -> np.ndarray:
    if not cells:
        return np.zeros((0, 0))
    max_r = max(r for r, _ in cells)
    max_c = max(c for _, c in cells)
    arr = np.full((max_r + 1, max_c + 1), np.nan)
    for (r, c), v in cells.items():
        arr[r, c] = v
    # drop rows/cols that contain no numbers (headers, padding)
    arr = arr[~np.all(np.isnan(arr), axis=1)]
    if arr.size:
        arr = arr[:, ~np.all(np.isnan(arr), axis=0)]
    return arr


# ------------------------------------------------------------------- xlsx


def _col_index(ref: str) -> int:
    """'C7' -> column 2."""
    col = 0
    for ch in ref:
        if ch.isalpha():
            col = col * 26 + (ord(ch.upper()) - ord("A") + 1)
        else:
            break
    return col - 1


def read_xlsx_numeric(path: str) -> np.ndarray:
    ns = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"
    with zipfile.ZipFile(path) as z:
        sheet_names = sorted(
            n
            for n in z.namelist()
            if re.match(r"xl/worksheets/sheet\d+\.xml$", n)
        )
        if not sheet_names:
            raise ValueError(f"no worksheets in {path}")
        root = ElementTree.fromstring(z.read(sheet_names[0]))
    cells: dict[tuple[int, int], float] = {}
    for row in root.iter(f"{ns}row"):
        r = int(row.attrib["r"]) - 1
        for cell in row.iter(f"{ns}c"):
            if cell.attrib.get("t") in ("s", "str", "inlineStr"):
                continue  # string cell
            v = cell.find(f"{ns}v")
            if v is None or v.text is None:
                continue
            try:
                val = float(v.text)
            except ValueError:
                continue
            cells[(r, _col_index(cell.attrib.get("r", "A1")))] = val
    return _cells_to_array(cells)


# -------------------------------------------------------------------- xls


def _ole2_workbook_stream(data: bytes) -> bytes:
    """Extract the Workbook/Book stream from an OLE2 compound file.

    Minimal reader: follows the FAT for the directory and stream chains;
    handles the mini-stream for small streams.
    """
    if data[:8] != b"\xd0\xcf\x11\xe0\xa1\xb1\x1a\xe1":
        raise ValueError("not an OLE2 compound file")
    sector_size = 1 << struct.unpack_from("<H", data, 30)[0]
    mini_size = 1 << struct.unpack_from("<H", data, 32)[0]
    num_fat = struct.unpack_from("<I", data, 44)[0]
    dir_start = struct.unpack_from("<i", data, 48)[0]
    mini_cutoff = struct.unpack_from("<I", data, 56)[0]
    minifat_start = struct.unpack_from("<i", data, 60)[0]
    difat_start = struct.unpack_from("<i", data, 68)[0]
    num_difat = struct.unpack_from("<I", data, 72)[0]

    # FAT sector list: 109 entries in header, then DIFAT chain
    fat_sectors = [
        s
        for s in struct.unpack_from("<109i", data, 76)[:num_fat]
        if s >= 0
    ]
    ds = difat_start
    for _ in range(num_difat):
        off = 512 + ds * sector_size
        entries = struct.unpack_from(
            f"<{sector_size // 4}i", data, off
        )
        fat_sectors.extend(s for s in entries[:-1] if s >= 0)
        ds = entries[-1]
        if ds < 0:
            break
    fat = []
    for s in fat_sectors:
        off = 512 + s * sector_size
        fat.extend(struct.unpack_from(f"<{sector_size // 4}i", data, off))

    def read_chain(start: int) -> bytes:
        out = bytearray()
        s = start
        seen = 0
        while s >= 0 and seen <= len(fat):
            off = 512 + s * sector_size
            out += data[off : off + sector_size]
            s = fat[s]
            seen += 1
        return bytes(out)

    directory = read_chain(dir_start)
    # directory entries are 128 bytes
    root_start = None
    target = None
    for i in range(0, len(directory), 128):
        entry = directory[i : i + 128]
        if len(entry) < 128:
            break
        name_len = struct.unpack_from("<H", entry, 64)[0]
        name = entry[: max(0, name_len - 2)].decode(
            "utf-16-le", errors="ignore"
        )
        start = struct.unpack_from("<i", entry, 116)[0]
        size = struct.unpack_from("<I", entry, 120)[0]
        if i == 0:
            root_start = start  # root entry: mini-stream location
        if name in ("Workbook", "Book"):
            target = (start, size)
    if target is None:
        raise ValueError("no Workbook stream found")
    start, size = target
    if size >= mini_cutoff:
        return read_chain(start)[:size]
    # mini-stream path
    mini_fat_raw = read_chain(minifat_start)
    minifat = struct.unpack_from(
        f"<{len(mini_fat_raw) // 4}i", mini_fat_raw, 0
    )
    ministream = read_chain(root_start)
    out = bytearray()
    s = start
    while s >= 0 and len(out) < size:
        out += ministream[s * mini_size : (s + 1) * mini_size]
        s = minifat[s]
    return bytes(out[:size])


def _decode_rk(rk: int) -> float:
    cent = rk & 1
    as_int = rk & 2
    raw = rk >> 2
    if as_int:
        val = float(raw if raw < (1 << 29) else raw - (1 << 30))
    else:
        val = struct.unpack("<d", struct.pack("<Q", raw << 34))[0]
    return val / 100.0 if cent else val


def read_xls_numeric(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    stream = _ole2_workbook_stream(data)
    cells: dict[tuple[int, int], float] = {}
    pos = 0
    n = len(stream)
    while pos + 4 <= n:
        rec, length = struct.unpack_from("<HH", stream, pos)
        body = stream[pos + 4 : pos + 4 + length]
        pos += 4 + length
        if rec == 0x0203 and len(body) >= 14:  # NUMBER
            r, c = struct.unpack_from("<HH", body, 0)
            (v,) = struct.unpack_from("<d", body, 6)
            cells[(r, c)] = v
        elif rec == 0x027E and len(body) >= 10:  # RK
            r, c = struct.unpack_from("<HH", body, 0)
            (rk,) = struct.unpack_from("<I", body, 6)
            cells[(r, c)] = _decode_rk(rk)
        elif rec == 0x00BD:  # MULRK
            r, c0 = struct.unpack_from("<HH", body, 0)
            nrk = (len(body) - 6) // 6
            for k in range(nrk):
                (rk,) = struct.unpack_from("<I", body, 4 + 6 * k + 2)
                cells[(r, c0 + k)] = _decode_rk(rk)
        elif rec == 0x000A:  # EOF of first (globals) or sheet substream
            # keep scanning: cells live in the sheet substreams
            continue
    return _cells_to_array(cells)
