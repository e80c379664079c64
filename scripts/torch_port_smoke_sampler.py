#!/usr/bin/env python3
"""Where chip_smoke.py's wall-clock time goes: runs it with a stack sampler.

    python3 scripts/torch_port_smoke_sampler.py OUT.json

Runs chip_smoke.py (from the repo root) in this process while a thread
reads the main thread's stack every 0.2 s. Each sample counts once for
the innermost chip_smoke.py frame (function:line) and once for the chain
of its four innermost chip_smoke.py frames. Writes {"period", "wall",
"inner", "chains"} to OUT.json; a count times the period is the seconds
spent there. Exits with chip_smoke.py's code.
"""

import collections
import json
import runpy
import sys
import threading
import time
from pathlib import Path

PERIOD = 0.2
ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    out = Path(sys.argv[1]).resolve()
    main_id = threading.main_thread().ident
    inner, chains = collections.Counter(), collections.Counter()
    stop = threading.Event()

    def sample():
        while not stop.wait(PERIOD):
            f = sys._current_frames().get(main_id)
            chain = []
            while f is not None:
                if f.f_code.co_filename.endswith("chip_smoke.py"):
                    chain.append(f"{f.f_code.co_name}:{f.f_lineno}")
                f = f.f_back
            if chain:
                inner[chain[0]] += 1
                chains[" < ".join(chain[:4])] += 1

    threading.Thread(target=sample, daemon=True).start()
    sys.path.insert(0, str(ROOT))
    sys.argv = [str(ROOT / "chip_smoke.py")]
    t0 = time.time()
    rc = 0
    try:
        runpy.run_path(str(ROOT / "chip_smoke.py"), run_name="__main__")
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else 1
    finally:
        stop.set()
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"period": PERIOD, "wall": time.time() - t0,
                                   "inner": inner.most_common(),
                                   "chains": chains.most_common(400)}))
    return rc


if __name__ == "__main__":
    sys.exit(main())
