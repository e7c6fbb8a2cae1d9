"""Parse the upstream reference's filter tables for differential verification.

This is a *test/dev utility only*: it reads the public reference implementation
(pierrepaleo/pypwt, mounted read-only) and extracts its numeric filter-bank
tables so that our independently *generated* filter banks can be checked for
behavioral parity.  Nothing parsed here is shipped; the shipped tables in
``pypwt_jax/filters`` are produced by ``tools/gen_filters.py`` from
mathematical constructions.

Reference layout: ``pdwt/src/filters.cpp`` defines, per wavelet, four arrays
(forward lo/hi, inverse lo/hi — same convention as pywt's
dec_lo/dec_hi/rec_lo/rec_hi) and a registry ``all_filters[72]``
(filters.cpp:5919-6009).
"""

from __future__ import annotations

import os
import re

import numpy as np

REFERENCE_ROOT = os.environ.get("PYPWT_REFERENCE", "/root/reference")
FILTERS_CPP = os.path.join(REFERENCE_ROOT, "pdwt", "src", "filters.cpp")

_ARRAY_RE = re.compile(
    r"DTYPE\s+(\w+)\s*\[\s*\d*\s*\]\s*=\s*\{([^}]*)\}", re.S
)
_REGISTRY_RE = re.compile(
    r'\{\s*"([^"]+)"\s*,\s*(\d+)\s*,\s*(\w+)\s*,\s*(\w+)\s*,\s*(\w+)\s*,\s*(\w+)\s*\}'
)


def available() -> bool:
    return os.path.isfile(FILTERS_CPP)


def parse_reference_filters():
    """Return {name: dict(hlen, dec_lo, dec_hi, rec_lo, rec_hi)} (float64)."""
    with open(FILTERS_CPP, "r") as f:
        src = f.read()

    arrays = {}
    for m in _ARRAY_RE.finditer(src):
        name, body = m.group(1), m.group(2)
        vals = [float(tok) for tok in re.findall(r"[-+0-9.eE]+", body)]
        arrays[name] = np.asarray(vals, dtype=np.float64)

    banks = {}
    for m in _REGISTRY_RE.finditer(src):
        wname, hlen = m.group(1), int(m.group(2))
        f_l, f_h, i_l, i_h = (arrays[m.group(k)] for k in range(3, 7))
        banks[wname] = {
            "hlen": hlen,
            # reference f_l/f_h/i_l/i_h == pywt dec_lo/dec_hi/rec_lo/rec_hi
            "dec_lo": f_l[:hlen],
            "dec_hi": f_h[:hlen],
            "rec_lo": i_l[:hlen],
            "rec_hi": i_h[:hlen],
        }
    return banks


if __name__ == "__main__":
    banks = parse_reference_filters()
    print(f"parsed {len(banks)} filter banks from {FILTERS_CPP}")
    for name in sorted(banks):
        print(f"  {name:10s} hlen={banks[name]['hlen']}")
