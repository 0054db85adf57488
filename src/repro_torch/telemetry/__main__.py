"""``python -m repro_torch.telemetry summarize <trace.json>``."""

import sys

from repro_torch.telemetry.summarize import main

if __name__ == "__main__":
    sys.exit(main())
