"""``python -m tenzing_tpu_torch.bench``: the driver's CLI (bench/driver.py)."""

import sys

from tenzing_tpu_torch.bench.driver import main

if __name__ == "__main__":
    sys.exit(main())
