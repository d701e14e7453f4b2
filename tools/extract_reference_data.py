"""Extract *data* (not code) from the reference TUNA package into JSON files.

The reference (h-brough/TUNA, mounted read-only at /root/reference) embeds
basis-set exponent/coefficient tables (tuna_basis.py:247-3041) and atomic
property tables (tuna_util.py:1676-1925) as Python literals.  These are
physical data (Basis Set Exchange tables, CODATA-derived atomic data), which
our rebuild stores as JSON data files instead of code.

Run from the repo root:  python tools/extract_reference_data.py
"""

import json
import sys
import pathlib

sys.path.insert(0, "/root/reference/TUNA")

import tuna_basis  # noqa: E402
import tuna_util  # noqa: E402

OUT = pathlib.Path(__file__).resolve().parent.parent / "tuna_tpu" / "basis" / "data"
OUT.mkdir(parents=True, exist_ok=True)


def extract_basis_sets():
    sets = {}
    for name in dir(tuna_basis):
        obj = getattr(tuna_basis, name)
        if name.startswith("_") and not name[1].isdigit():
            continue
        if not isinstance(obj, dict):
            continue
        # Basis dicts map int Z -> list of (ang_mom_letter, [(exp, coeff), ...])
        if not obj or not all(isinstance(k, int) for k in obj):
            continue
        sets[name] = {
            str(z): [[ang, [[float(e), float(c)] for e, c in prims]] for ang, prims in shells]
            for z, shells in obj.items()
        }
    with open(OUT / "basis_sets.json", "w") as f:
        json.dump(sets, f)
    print(f"wrote {len(sets)} basis sets -> {OUT/'basis_sets.json'}")


def extract_atomic_data():
    atoms = {}
    for symbol, props in tuna_util.atomic_properties.items():
        entry = dict(props)
        density = entry.pop("density")
        entry["sad_density"] = None if density is None else [[float(x) for x in row] for row in density]
        atoms[symbol] = entry
    with open(OUT / "atoms.json", "w") as f:
        json.dump(atoms, f, indent=1)
    print(f"wrote {len(atoms)} atoms -> {OUT/'atoms.json'}")


if __name__ == "__main__":
    extract_basis_sets()
    extract_atomic_data()
