"""foldcomp-compatible Python API.

Mirrors the reference CPython extension module `foldcomp`
(foldcomp/foldcomp.cxx:702-724): `compress`, `decompress`, `open` (database
as a Python sequence + context manager), `get_data`, plus the pure-Python
helpers `setup`/`setup_async` (foldcomp/setup.py) and `split_pdb_by_chain`
(foldcomp/util.py). A user of the reference package can import these names
from `foldcomp_tpu_torch` unchanged.

The port's own copy of `foldcomp_tpu/api.py:1`, kept line for line: the
API runs the exact native codec and never the device, so it imports
neither torch nor JAX (tests/test_torch_api.py holds the two copies to the
same results).
"""
from __future__ import annotations

import numpy as np

from .codec import fcz
from .codec.decoder import decode as _decode_exact
from .codec.encoder import encode as _encode_exact
from .core import exact as _exact
from .io.db import DatabaseReader
from .io.pdb import format_pdb
from .io.structure import AtomArray, remove_alternative_positions

DEFAULT_ANCHOR_THRESHOLD = fcz.DEFAULT_ANCHOR_THRESHOLD


class FoldcompError(Exception):
    """Parity with the reference module's foldcomp.error."""


def _parse_atom_lines(pdb_input: str, require_single_chain: bool):
    """The binding's minimal ATOM-line parser (foldcomp.cxx:253-293)."""
    names, rnames, chains = [], [], []
    aidx, ridx, coords, occ, tf = [], [], [], [], []
    chain = None
    for line in pdb_input.splitlines():
        if not line.startswith("ATOM"):
            continue
        c = line[21:22]
        if chain is None:
            chain = c
        elif require_single_chain and c != chain:
            raise FoldcompError(
                "Multiple chains found. Please provide a single chain using "
                "'foldcomp.split_pdb_by_chain'")
        names.append(line[12:16].strip())
        rnames.append(line[17:20].strip())
        chains.append(chain)
        aidx.append(int(line[6:11]))
        ridx.append(int(line[22:26]))
        coords.append((float(line[30:38]), float(line[38:46]),
                       float(line[46:54])))
        occ.append(float(line[54:60]))
        tf.append(float(line[60:66]))
    if not names:
        raise FoldcompError("No ATOM lines found")
    return AtomArray(
        names, rnames, chains, np.asarray(aidx, np.int32),
        np.asarray(ridx, np.int32), np.asarray(coords, np.float32),
        np.asarray(occ, np.float32), np.asarray(tf, np.float32), "")


def compress(name: str, pdb_content: str,
             anchor_residue_threshold: int = DEFAULT_ANCHOR_THRESHOLD) -> bytes:
    """PDB string -> FCZ bytes (foldcomp.cxx:295-328 parity)."""
    if anchor_residue_threshold < 1:
        raise FoldcompError("anchor_residue_threshold must be >= 1")
    # the binding's parser consumes ATOM records only and rejects
    # multi-chain input (foldcomp.cxx:253-293)
    atom_lines = []
    chain = None
    for line in pdb_content.splitlines():
        if not line.startswith("ATOM"):
            continue
        c = line[21:22]
        if chain is None:
            chain = c
        elif c != chain:
            raise FoldcompError(
                "Multiple chains found. Please provide a single chain using "
                "'foldcomp.split_pdb_by_chain'")
        atom_lines.append(line)
    if not atom_lines:
        raise FoldcompError("No ATOM lines found")

    try:
        from .native import encode_pdb_native
        frags = encode_pdb_native(
            ("\n".join(atom_lines) + "\n").encode("latin1", "replace"),
            anchor_residue_threshold, name, split=False)
    except Exception:
        frags = None
    if frags:
        f = frags[0]
        if f["error"]:
            raise FoldcompError(f"Error compressing: {f['error']}")
        return f["blob"]

    atoms = _parse_atom_lines(pdb_content, require_single_chain=True)
    atoms = remove_alternative_positions(atoms)
    try:
        data = _encode_exact(atoms, anchor_threshold=anchor_residue_threshold,
                             title=name)
    except ValueError as e:
        raise FoldcompError(f"Error compressing: {e}") from e
    return fcz.serialize(data)


def decompress(fcz_bytes: bytes):
    """FCZ bytes -> (name, pdb_str) (foldcomp.cxx:222-239 parity).

    Note the binding calls decompress(..., /*use_title=*/false), so the PDB
    text carries no TITLE records; the title is returned separately.
    """
    try:
        blob = bytes(fcz_bytes)
        f = fcz.parse(blob)
    except Exception as e:
        raise FoldcompError("Error decompressing.") from e
    try:
        from .native import decode_fcz_pdb_native
        text = decode_fcz_pdb_native(blob)
    except Exception:
        text = None
    if text is not None:
        # strip TITLE records: the native decoder embeds them
        if text.startswith("TITLE"):
            lines = text.splitlines(keepends=True)
            text = "".join(l for l in lines if not l.startswith("TITLE"))
        return f.title, text
    try:
        atoms = _decode_exact(f)
    except Exception as e:
        raise FoldcompError("Error decompressing.") from e
    return f.title, format_pdb(atoms)


class FoldcompDatabase:
    """MMseqs2-style database as a sequence + context manager.

    Iteration yields (name, pdb_str) when decompress=True, raw FCZ bytes
    otherwise — exactly like FoldcompDatabase_sq_item (foldcomp.cxx:53-90).
    """

    def __init__(self, path: str, ids=None, decompress: bool = True,
                 err_on_missing: bool = False):
        import os
        import sys
        self._reader = DatabaseReader(os.fspath(path))
        self._decompress = decompress
        self._user_indices = None
        if ids:
            self._user_indices = []
            for name in ids:
                key = self._reader.lookup_key(name)
                pos = self._reader.position_of_key(key) \
                    if key != 0xFFFFFFFF else -1
                if pos < 0:
                    msg = f"Skipping entry {name} which is not in the database."
                    if err_on_missing:
                        self.close()
                        raise KeyError(msg)
                    print(msg, file=sys.stderr)
                    continue
                self._user_indices.append(pos)

    def __len__(self):
        if self._user_indices is not None:
            return len(self._user_indices)
        return len(self._reader)

    def __getitem__(self, index):
        if isinstance(index, slice):
            return [self[i] for i in range(*index.indices(len(self)))]
        n = len(self)
        if index < 0:
            index += n
        if not 0 <= index < n:
            raise IndexError("index out of range")
        pos = self._user_indices[index] if self._user_indices is not None \
            else index
        data = self._reader.get_data(pos)
        # stored entries are NUL-terminated (writer_append parity)
        if data.endswith(b"\x00"):
            data = data[:-1]
        if self._decompress:
            return decompress(data)
        return data

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def close(self):
        self._reader.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def open(path, ids=None, decompress: bool = True,
         err_on_missing: bool = False) -> FoldcompDatabase:  # noqa: A001
    """foldcomp.open parity (foldcomp.cxx:333-435)."""
    return FoldcompDatabase(path, ids=ids, decompress=decompress,
                            err_on_missing=err_on_missing)


def get_data(input) -> dict:  # noqa: A002
    """FCZ bytes or PDB string -> angle/residue/coordinate dict
    (foldcomp.cxx:496-695 parity).

    Keys: phi, psi, omega, torsion_angles, bond_angles, residues, b_factors,
    coordinates.
    """
    if isinstance(input, str):
        raw = input.encode("latin1", "replace")
    else:
        raw = bytes(input)
    if len(raw) == 0:
        raise ValueError("Input is empty")
    if len(raw) < 4:
        raise ValueError("Input is not a FCZ file or PDB file")

    if raw[:4] == fcz.MAGIC:
        f = fcz.parse(raw)
        atoms = _decode_exact(f)
        from .codec.fcz import unpack_records
        from .core.codes import one_letter_from_int
        res_code, phi_q, psi_q, omega_q, _, _, _ = unpack_records(f.records)

        def cont(q, idx):
            d = _exact.Discretizer.from_params(f.mins[idx], f.cont_fs[idx])
            return d.continuize(q)

        phi = cont(phi_q, 0)
        psi = cont(psi_q, 1)
        omega = cont(omega_q, 2)
        n_ca_c = cont(unpack_records(f.records)[4], 3)
        ca_c_n = cont(unpack_records(f.records)[5], 4)
        c_n_ca = cont(unpack_records(f.records)[6], 5)
        n = f.n_residue
        torsion_angles = [float(v) for i in range(n - 1)
                          for v in (psi[i], omega[i], phi[i])]
        bond_angles = [float(v) for i in range(n - 1)
                       for v in (ca_c_n[i], c_n_ca[i], n_ca_c[i])]
        tf_disc = _exact.Discretizer.from_params(f.tf_min, f.tf_cont)
        b_factors = [float(x) for x in tf_disc.continuize(f.tf_codes)]
        residues = "".join(one_letter_from_int(int(c)) for c in res_code)
        return {
            "phi": [float(x) for x in phi],
            "psi": [float(x) for x in psi],
            "omega": [float(x) for x in omega],
            "torsion_angles": torsion_angles,
            "bond_angles": bond_angles,
            "residues": residues,
            "b_factors": b_factors,
            "coordinates": [[float(c) for c in xyz] for xyz in atoms.coords],
        }

    # PDB input: compute raw (pre-quantization) angles like the compress path
    atoms = _parse_atom_lines(raw.decode("latin1"), require_single_chain=False)
    from .codec.encoder import BACKBONE
    from .core.codes import one_letter_from_three
    bb_idx = [i for i in range(len(atoms)) if atoms.atom_name[i] in BACKBONE]
    n_res = len(bb_idx) // 3
    if n_res < 2:
        raise ValueError("Could not parse structure from input")
    flat_bb = atoms.coords[np.asarray(bb_idx[:3 * n_res], np.int64)]
    tors = _exact.backbone_torsions(flat_bb)
    angs = _exact.backbone_bond_angles(flat_bb)
    psi, omega, phi = tors[0::3], tors[1::3], tors[2::3]
    tf = [float(atoms.temp_factor[i]) for i in range(len(atoms))
          if atoms.atom_name[i] == "CA"]
    residues = "".join(
        one_letter_from_three(atoms.residue_name[bb_idx[i * 3]])
        for i in range(n_res))
    return {
        "phi": [float(x) for x in phi],
        "psi": [float(x) for x in psi],
        "omega": [float(x) for x in omega],
        "torsion_angles": [float(x) for x in tors],
        "bond_angles": [float(x) for x in angs],
        "residues": residues,
        "b_factors": tf,
        "coordinates": [[float(c) for c in xyz] for xyz in atoms.coords],
    }


def split_pdb_by_chain(pdb_str: str):
    """Split a PDB string into one string per chain (foldcomp/util.py)."""
    pdb_list = []
    chain = None
    chain_str = ""
    for line in pdb_str.splitlines():
        if line.startswith("ATOM"):
            if chain is None:
                chain = line[21]
            elif line[21] != chain:
                pdb_list.append(chain_str)
                chain_str = ""
                chain = line[21]
            chain_str += line + "\n"
    pdb_list.append(chain_str)
    return pdb_list


_DOWNLOAD_BASE = "https://opendata.mmseqs.org/foldcomp/"
_DB_SUFFIXES = ("", ".index", ".dbtype", ".lookup", ".source")


async def setup_async(db: str = "afdb_swissprot", download_chunks: int = 16):
    """Prebuilt-database downloader (foldcomp/setup.py:90-107 parity).

    Downloads {db, db.index, db.dbtype, db.lookup, db.source} from
    opendata.mmseqs.org with chunked, resumable range requests.
    """
    try:
        import httpx  # noqa: F401
    except ImportError as e:  # pragma: no cover
        raise FoldcompError(
            "setup() requires the 'httpx' package for downloads") from e
    from ._setup_download import download
    for suffix in _DB_SUFFIXES:
        await download(f"{_DOWNLOAD_BASE}{db}{suffix}", f"{db}{suffix}",
                       chunks=download_chunks)


def setup(db: str = "afdb_swissprot", download_chunks: int = 16):
    import asyncio
    asyncio.run(setup_async(db, download_chunks))
