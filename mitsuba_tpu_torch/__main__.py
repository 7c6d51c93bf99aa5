"""`python -m mitsuba_tpu_torch scene.xml ...`: the command-line renderer
(cli.py)."""
from mitsuba_tpu_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
