"""Native (C++) runtime components, loaded via ctypes.

Where the reference's runtime is native C++ (BVH builder, loaders), this
package provides native equivalents — compiled lazily with
the system toolchain and falling back to the NumPy implementations when a
compiler is unavailable.
"""

from .loader import get_bvh_lib, native_available
