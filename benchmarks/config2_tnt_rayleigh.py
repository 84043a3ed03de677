"""Config 2: TNT Rayleigh-quotient minimization on S^{n-1}, n = 2^24.

The headline benchmark — identical to bench.py (single source of truth):
TNT through the single-synchronization flat CG engine; value = CG
iterations/s.  See bench.py for the full methodology.
"""

import bench


def main():
    bench.main()


if __name__ == "__main__":
    main()
