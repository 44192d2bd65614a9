"""The port's benchmark harness: one module per paper table or figure.

  bench_linreg       Fig. 5 (convergence) and Fig. 4 (gamma and k)
  bench_cifar_proxy  Table 6 / Fig. 3 (four optimizer pairs at large batch)
  bench_bert_proxy   Table 1 (pretraining quality against batch) and the
                     autoscale A/B
  bench_gengap       Tables 2 and 4 (the generalization gap)
  bench_dlrm_proxy   Table 5 (CTR AUC against batch)

Each prints ``name,us_per_call,derived`` CSV rows under the reference's
row names (``benchmarks/run.py``).  The reference's ``data``, ``overhead``,
``roofline`` and ``serve`` benches and its ``--check-regression`` have no
port yet; asking for them is refused.

  python -m repro_torch.benchmarks.run                  # all five, on the card
  python -m repro_torch.benchmarks.run --fast --only linreg --device cpu
"""
from __future__ import annotations

import argparse
import importlib
import sys
import time
import traceback

MODULES = ["linreg", "cifar_proxy", "bert_proxy", "gengap", "dlrm_proxy"]
NOT_PORTED = ["data", "overhead", "roofline", "serve"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fast", action="store_true", help="the reference's reduced sweeps")
    ap.add_argument("--only", default="", help="comma-separated: " + ",".join(MODULES))
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--record", default=None,
                    help="bert_proxy's autoscale record (default: build/bench_autoscale.json)")
    args = ap.parse_args(argv)
    only = [s.strip() for s in args.only.split(",") if s.strip()]
    refused = [m for m in only if m in NOT_PORTED]
    unknown = [m for m in only if m not in MODULES + NOT_PORTED]
    if refused or unknown:
        print(f"# not ported yet: {', '.join(refused) or '-'}; unknown: "
              f"{', '.join(unknown) or '-'}; this harness runs {', '.join(MODULES)}",
              file=sys.stderr)
        return 2
    from repro_torch.serve.engine import resolve_device

    device = resolve_device(args.device)
    print(f"# device {device}; not ported yet, not run: {', '.join(NOT_PORTED)}")
    print("name,us_per_call,derived")
    t0 = time.time()
    failures = []
    for mod in MODULES:
        if only and mod not in only:
            continue
        kw = {"device": device}
        if mod == "bert_proxy" and args.record:
            kw["record_path"] = args.record
        try:
            importlib.import_module(f"repro_torch.benchmarks.bench_{mod}").main(
                fast=args.fast, **kw)
        except Exception:  # noqa: BLE001 — report it, run the rest, exit 1
            failures.append(mod)
            print(f"# bench_{mod} FAILED:", file=sys.stderr)
            traceback.print_exc()
    print(f"# total {time.time() - t0:.1f}s; failures: {failures or 'none'}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
