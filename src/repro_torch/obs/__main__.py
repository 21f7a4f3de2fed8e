"""CLI: ``python -m repro_torch.obs <trace.json> [...]`` — validate exported
traces (``launch/serve.py --trace-out``) against the trace_event schema
and check that their spans nest; exits 1 on any problem."""
from __future__ import annotations

import json
import sys

from .trace import check_span_nesting, validate_trace


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: python -m repro_torch.obs <trace.json> [...]",
              file=sys.stderr)
        return 2
    rc = 0
    for path in argv:
        with open(path) as f:
            obj = json.load(f)
        problems = validate_trace(obj)
        problems += check_span_nesting(obj.get("traceEvents", []))
        events = obj.get("traceEvents", [])
        other = obj.get("otherData", {})
        print(f"{path}: {len(events)} events "
              f"(recorded={other.get('recorded')}, "
              f"dropped={other.get('dropped')}, "
              f"capacity={other.get('capacity')})")
        for p in problems:
            print(f"  {p}")
            rc = 1
        if not problems:
            print("  OK: schema valid, spans balanced")
    return rc


if __name__ == "__main__":
    sys.exit(main())
