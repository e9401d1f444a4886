"""Serve gaze-map inference over HTTP from a bundle, on the card.

    python -m recurrent_gaze_prediction_tpu_torch.cli.serve \
        --bundle /tmp/rgp_bundle --port 8500 [--device cuda]

The bundle may come from either package's `save_bundle` (or the JAX
package's `cli.export_serving`). Concurrent single-clip POSTs are coalesced
by the dynamic micro-batcher (`serving/server.py`).
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

from ..utils import log


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--bundle", required=True,
                        help="bundle directory (manifest.json + params.npz)")
    parser.add_argument("--program", default="predict",
                        choices=["predict", "fused", "fused_int8", "stream"])
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", default=8500, type=int)
    parser.add_argument("--max_batch", default=32, type=int)
    parser.add_argument("--max_wait_ms", default=5.0, type=float)
    parser.add_argument("--device", default="cuda",
                        help="torch device; the default needs a CUDA card")
    return parser


def main(argv: Optional[list[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    from ..serving import server_from_bundle

    server = server_from_bundle(
        args.bundle, program=args.program, host=args.host, port=args.port,
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        device=args.device)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        log.warn("interrupted; shutting down")
    finally:
        server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
