"""Minimal mmCIF parser (gemmi-equivalent subset used by the reference).

The reference vendors gemmi and uses only: the _atom_site loop (atom name,
residue name, chain, serial, seq id, xyz, B-factor), `_entry.id` and
`_struct.title` (structure_reader.cpp:31-61). This parser covers that subset
for plain and gzipped mmCIF.

The port's own copy of `foldcomp_tpu/io/cif.py:1`, kept line for line so
that both packages write the same bytes (tests/test_torch_standalone.py
holds the two to the same results).
"""
from __future__ import annotations

import gzip

import numpy as np

from .structure import AtomArray

F32 = np.float32


def _tokenize(line: str):
    """Split an mmCIF data line honoring single/double quotes."""
    out = []
    i = 0
    n = len(line)
    while i < n:
        c = line[i]
        if c in " \t":
            i += 1
            continue
        if c in "'\"":
            j = line.find(c, i + 1)
            # cif quote ends at quote followed by whitespace/EOL
            while j != -1 and j + 1 < n and line[j + 1] not in " \t":
                j = line.find(c, j + 1)
            if j == -1:
                out.append(line[i + 1:])
                i = n
            else:
                out.append(line[i + 1:j])
                i = j + 1
        else:
            j = i
            while j < n and line[j] not in " \t":
                j += 1
            out.append(line[i:j])
            i = j
    return out


def parse_cif(data, default_title: str = "") -> AtomArray:
    """Parse the _atom_site loop of an mmCIF file (optionally gzipped bytes)."""
    if isinstance(data, bytes):
        if data[:2] == b"\x1f\x8b":
            data = gzip.decompress(data)
        text = data.decode("utf-8", "replace")
    else:
        text = data

    lines = text.splitlines()
    entry_id = ""
    struct_title = ""

    atom_name, residue_name, chain = [], [], []
    atom_index, residue_index = [], []
    xs, ys, zs, occ, bf = [], [], [], [], []

    i = 0
    n_lines = len(lines)
    n_blocks = 0
    while i < n_lines:
        line = lines[i].strip()
        if line.startswith("data_"):
            # multi-datablock file: read the FIRST block only (gemmi's
            # read_structure convention; the reference binary rejects the
            # whole file with "No atoms found" — structure_reader.cpp:86 —
            # which tests/test_foreign_corpus.py pins as a defect)
            n_blocks += 1
            if n_blocks > 1:
                break
        elif line.startswith("_entry.id"):
            toks = _tokenize(line)
            if len(toks) >= 2:
                entry_id = toks[1]
        elif line.startswith("_struct.title"):
            toks = _tokenize(line)
            if len(toks) >= 2:
                struct_title = toks[1]
            elif i + 1 < n_lines and lines[i + 1].startswith(";"):
                # multiline value
                parts = [lines[i + 1][1:].strip()]
                j = i + 2
                while j < n_lines and not lines[j].startswith(";"):
                    parts.append(lines[j].strip())
                    j += 1
                struct_title = " ".join(p for p in parts if p)
                i = j
        elif line == "loop_":
            # collect tags
            tags = []
            j = i + 1
            while j < n_lines and lines[j].strip().startswith("_"):
                tags.append(lines[j].strip().split()[0])
                j += 1
            if tags and tags[0].startswith("_atom_site."):
                col = {t[len("_atom_site."):]: k for k, t in enumerate(tags)}
                ncols = len(tags)

                def pick(row, *names, default=""):
                    for nm in names:
                        k = col.get(nm)
                        if k is not None and k < len(row) and row[k] not in ("?", "."):
                            return row[k]
                    return default

                # Values are accumulated as a token stream: CIF rows may wrap
                # across lines and may contain ';'-delimited text blocks. A
                # loop whose token count is not a multiple of the tag count is
                # malformed; gemmi throws and the reference rejects the whole
                # file ("No atoms found", structure_reader.cpp loadFromBuffer
                # catch), so we do the same instead of mis-aligning columns.
                buf = []
                while j < n_lines:
                    row_line = lines[j]
                    s = row_line.strip()
                    if not s or s.startswith("#") or s == "loop_" \
                            or s.startswith("_") or s.startswith("data_"):
                        break
                    if row_line.startswith(";"):
                        # multiline text value: one token up to closing ';'
                        val = [row_line[1:].strip()]
                        j += 1
                        while j < n_lines and not lines[j].startswith(";"):
                            val.append(lines[j].strip())
                            j += 1
                        j += 1  # closing ';'
                        buf.append(" ".join(v for v in val if v))
                    else:
                        buf.extend(_tokenize(row_line))
                        j += 1
                    while len(buf) >= ncols:
                        row = buf[:ncols]
                        del buf[:ncols]
                        atom_name.append(pick(row, "auth_atom_id",
                                              "label_atom_id"))
                        residue_name.append(pick(row, "auth_comp_id",
                                                 "label_comp_id"))
                        chain.append(pick(row, "auth_asym_id",
                                          "label_asym_id"))
                        try:
                            atom_index.append(int(pick(row, "id", default="0")))
                        except ValueError:
                            atom_index.append(0)
                        try:
                            residue_index.append(int(pick(
                                row, "auth_seq_id", "label_seq_id",
                                default="0")))
                        except ValueError:
                            residue_index.append(0)
                        try:
                            xs.append(float(pick(row, "Cartn_x", default="0")))
                            ys.append(float(pick(row, "Cartn_y", default="0")))
                            zs.append(float(pick(row, "Cartn_z", default="0")))
                        except ValueError:
                            xs.append(0.0), ys.append(0.0), zs.append(0.0)
                        try:
                            occ.append(float(pick(row, "occupancy",
                                                  default="1")))
                        except ValueError:
                            occ.append(1.0)
                        try:
                            bf.append(float(pick(row, "B_iso_or_equiv",
                                                 default="0")))
                        except ValueError:
                            bf.append(0.0)
                if buf:
                    # ragged loop: reject the whole file like the reference
                    atom_name, residue_name, chain = [], [], []
                    atom_index, residue_index = [], []
                    xs, ys, zs, occ, bf = [], [], [], [], []
                    i = n_lines
                    break
                i = j - 1
            else:
                i = j - 1
        i += 1

    title = entry_id or struct_title or default_title
    coords = np.stack([np.asarray(xs, np.float64), np.asarray(ys, np.float64),
                       np.asarray(zs, np.float64)], axis=-1).astype(F32) \
        if xs else np.zeros((0, 3), F32)
    return AtomArray(
        atom_name, residue_name, chain,
        np.asarray(atom_index, np.int32), np.asarray(residue_index, np.int32),
        coords, np.asarray(occ, F32), np.asarray(bf, F32), title,
    )
