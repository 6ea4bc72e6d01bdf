"""Live run monitor CLI: ``python -m easyhec_torch.cli.watch runs/<run>``.

Counterpart of easyhec_tpu/cli/watch.py: drops ``live.html`` in the run dir
and serves it on 127.0.0.1 with the standard-library HTTP server (no torch
or GPU involved). Open http://localhost:<port>/live.html while a
calibration (offline or online) is writing metrics.jsonl and images/.
"""
from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="live run monitor")
    ap.add_argument("run_dir", help="run directory (output_dir of a run)")
    ap.add_argument("--port", type=int, default=8008)
    args = ap.parse_args(argv)

    from ..utils.live import DASHBOARD_NAME, serve, write_dashboard

    write_dashboard(args.run_dir)
    print(f"serving {args.run_dir} — open http://localhost:{args.port}/{DASHBOARD_NAME}")
    serve(args.run_dir, port=args.port)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
