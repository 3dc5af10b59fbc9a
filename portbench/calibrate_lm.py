"""The readings that the limits of an ``lm_train`` cell's ``correct`` are set
from, on the card: :mod:`portbench.calibrate` with the faults that act on
that loop (the lower-precision control, an unchanged optimizer step, half
the batch's rows in the likelihood)::

    python3 -m portbench.calibrate_lm --cells dsv2lite-whvi.train-t1024 \
        [--seeds 12] [--faulty-seeds 3] [--seconds 1] [--out FILE]
"""

from __future__ import annotations

import sys

from portbench import calibrate

calibrate.FAULTS.setdefault("lm_train", ("control_bf16", "unchanged_step", "half_batch"))

if __name__ == "__main__":
    sys.exit(calibrate.main())
