"""Offline gaze .mat preprocessing: add the multi-resolution gazemap and
fixation keys in place. The port's counterpart of the JAX package's
`cli/process_gazemap.py` (the reference's `process_gazemap.py:139-158`).

    python -m recurrent_gaze_prediction_tpu_torch.cli.process_gazemap \\
        --glob '/data/gazemap/*.mat' --num_agents 1

Host-only (numpy, scipy and h5py; no device). With the `AGENT_ID`
environment variable set, process i handles the files where
i % num_agents == AGENT_ID, for manually parallel runs.
"""

from __future__ import annotations

import argparse
import os
import sys
from glob import glob
from typing import Optional

from ..data.gazemap import process_mat_file
from ..utils import log


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("--glob", default="*.mat")
    parser.add_argument("--override", action="store_true",
                        help="recompute keys even if present")
    parser.add_argument("--num_agents", default=8, type=int)
    return parser


def main(argv: Optional[list[str]] = None) -> int:
    import h5py

    args = build_parser().parse_args(argv)
    agent_id = (int(os.environ["AGENT_ID"])
                if "AGENT_ID" in os.environ else None)

    for i, path in enumerate(sorted(glob(args.glob))):
        if agent_id is not None and i % args.num_agents != agent_id:
            continue
        log.info("[agent %s] %d %s", agent_id, i, path)
        with h5py.File(path, "r+") as mat:
            process_mat_file(mat, force=args.override)
    return 0


if __name__ == "__main__":
    sys.exit(main())
