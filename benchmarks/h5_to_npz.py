"""Write .npz copies of the HDF5 cases and goldens that the GPU runs read.

A machine that runs chip_smoke.py, bench.py or the scripts here need not
have h5py; numpy reads .npz everywhere. Each dataset is stored under its
HDF5 path (for example "bus/layout/type"), string datasets as unicode
arrays, and each attribute of the file's root under "@<name>".
``jg.power_system("<case>.npz")`` reads such a file through the same
loader as the HDF5 original (tests/test_io.py checks that they agree).

Run from the repo root:  python benchmarks/h5_to_npz.py
Writes tests/data/<name>.npz next to each source file.
"""

import os

import h5py
import numpy as np

DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests", "data")
FILES = ["case1354pegase.h5", "case1951rte.h5", "case_ACTIVSg10k.h5",
         "results_large.h5"]


def _plain(value):
    """Strings (bytes or h5py's object arrays of them) as unicode."""
    value = np.asarray(value)
    if value.dtype.kind in "OS":
        flat = [v.decode() if isinstance(v, bytes) else str(v)
                for v in value.reshape(-1)]
        return np.asarray(flat).reshape(value.shape)
    return value


def h5_arrays(path):
    """Every dataset of an HDF5 file by path, plus root attributes."""
    out = {}
    with h5py.File(path, "r") as fh:
        for name, value in fh.attrs.items():
            out[f"@{name}"] = _plain(value)

        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = _plain(obj[()])

        fh.visititems(visit)
    return out


def main():
    for name in FILES:
        src = os.path.join(DATA, name)
        dst = os.path.splitext(src)[0] + ".npz"
        np.savez_compressed(dst, **h5_arrays(src))
        print(dst, os.path.getsize(dst))


if __name__ == "__main__":
    main()
