"""The readings that the SwinUNETR cell's limits are set from, in one
process:

    python3 -m bench_torch.swinunetr_control --workload <cell>
        --seeds 1,2,... [--control-seeds 101,102,103] [--seconds 3]
        [--served 500]

``control``'s runs and summary (the program's readings at the cell's own
load; the control on the volumes a window serving ``--served`` volumes
compares), with SwinUNETR's control: its plain reference with TF32
allowed, put in the program's place.  Needs the card."""
from __future__ import annotations

import sys

from bench_torch import control, swinunetr_program


def main(argv=None, root=None, device=None):
    # control.main reads its control from this module attribute
    control.control_readings = swinunetr_program.control_readings
    return control.main(argv, root, device)


if __name__ == "__main__":
    sys.exit(main())
