"""A minimal .xlsx writer and reader (one sheet of numbers), the port's own
copy of the JAX package's ``utils/xlsx.py``.

The reference ships its headline curves as Excel files
(``data/*_grasp.xlsx``, ``voting*.xlsx``). No spreadsheet library is
needed: the writer emits the small OOXML zip directly, and the reader
reads it (and the reference's pandas-written artifacts) back the same way.
Pandas, openpyxl and Excel read what the writer writes.
"""
from __future__ import annotations

import re
import xml.etree.ElementTree as ET
import zipfile

import numpy as np

_CONTENT_TYPES = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">
<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>
<Default Extension="xml" ContentType="application/xml"/>
<Override PartName="/xl/workbook.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>
<Override PartName="/xl/worksheets/sheet1.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.worksheet+xml"/>
</Types>"""

_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" Target="xl/workbook.xml"/>
</Relationships>"""

_WORKBOOK = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main" xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">
<sheets><sheet name="Sheet1" sheetId="1" r:id="rId1"/></sheets></workbook>"""

_WB_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/worksheet" Target="worksheets/sheet1.xml"/>
</Relationships>"""


def _col_name(i: int) -> str:
    name = ""
    i += 1
    while i:
        i, r = divmod(i - 1, 26)
        name = chr(65 + r) + name
    return name


def write_xlsx(path: str, data: np.ndarray) -> None:
    """Write a 1-D or 2-D numeric array as sheet1 of an xlsx file; a 1-D
    array becomes one column."""
    arr = np.atleast_2d(np.asarray(data, dtype=np.float64))
    if arr.shape[0] == 1 and np.asarray(data).ndim == 1:
        arr = arr.T
    rows_xml = []
    for r, row in enumerate(arr, start=1):
        cells = "".join(
            f'<c r="{_col_name(c)}{r}"><v>{float(v)!r}</v></c>'
            for c, v in enumerate(row))
        rows_xml.append(f'<row r="{r}">{cells}</row>')
    sheet = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<worksheet xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main">'
        f"<sheetData>{''.join(rows_xml)}</sheetData></worksheet>")
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("[Content_Types].xml", _CONTENT_TYPES)
        z.writestr("_rels/.rels", _RELS)
        z.writestr("xl/workbook.xml", _WORKBOOK)
        z.writestr("xl/_rels/workbook.xml.rels", _WB_RELS)
        z.writestr("xl/worksheets/sheet1.xml", sheet)


_CELL_REF = re.compile(r"([A-Z]+)(\d+)")
_NS = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"


def read_xlsx(path: str) -> np.ndarray:
    """Sheet1 as a dense 2-D float64 array (NaN for holes and for
    non-numeric cells). The inverse of :func:`write_xlsx`; a 1-column
    sheet comes back as shape ``(rows, 1)``."""
    with zipfile.ZipFile(path) as z:
        sheet_name = next(n for n in z.namelist()
                          if n.endswith("worksheets/sheet1.xml"))
        root = ET.fromstring(z.read(sheet_name))
    cells: list[tuple[int, int, float]] = []
    for c in root.iter(f"{_NS}c"):
        ref = c.get("r")
        v = c.find(f"{_NS}v")
        if ref is None or v is None or v.text is None:
            continue
        m = _CELL_REF.fullmatch(ref)
        if not m:
            continue
        col = 0
        for ch in m.group(1):
            col = col * 26 + (ord(ch) - 64)
        try:
            val = float(v.text)
        except ValueError:  # a shared-string or formula cell
            val = float("nan")
        cells.append((int(m.group(2)) - 1, col - 1, val))
    if not cells:
        return np.empty((0, 0), dtype=np.float64)
    n_r = max(r for r, _, _ in cells) + 1
    n_c = max(c for _, c, _ in cells) + 1
    out = np.full((n_r, n_c), np.nan, dtype=np.float64)
    for r, c, val in cells:
        out[r, c] = val
    return out
