# Copy of tntblast_tpu/utils/cppio.py with the package name changed.
"""C++ iostream-compatible number formatting.

The reference prints all floats with the default ostream precision of 6
significant digits (general format), after the float -> double promotion.
Replicating this exactly is part of the output contract (golden files are
compared byte-for-byte).
"""

import math

import numpy as np


def cpp(x):
    """Format a number the way `std::ostream <<` would."""
    if isinstance(x, (int, np.integer)):
        return str(int(x))
    v = float(x)
    if math.isinf(v):
        return "-inf" if v < 0 else "inf"
    if math.isnan(v):
        return "nan" if not math.copysign(1.0, v) < 0 else "-nan"
    return f"{v:.6g}"


def cpp_f32(x):
    """Format after rounding through float32 (for values the reference
    stores as C float)."""
    return cpp(float(np.float32(x)))
