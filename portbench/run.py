"""Run one cell of the port's benchmark on this machine's cards.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is the result as one JSON object; the
numbers the comparison judged, each beside its limit, are the last lines
of standard error. Without enough CUDA cards it exits with 2 and prints
no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache at a fixed path inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton"}


def nvidia_smi():
    query = "name,power.limit,power.draw,clocks.sm,clocks.mem,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().replace("\n", " | ")
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi failed: {exc!r}"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(ROOT, "build", "portbench", sub)
    sys.path.insert(0, ROOT)
    import torch
    from portbench import harness
    cell = harness.Cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    devices = harness.Devices([torch.device("cuda", i)
                               for i in range(cell.chips)])
    torch.cuda.set_device(0)
    result = harness.run(cell, devices, args.seed, args.seconds,
                         bool(args.trace), T0)
    print("nvidia-smi: " + nvidia_smi(), file=sys.stderr)
    return finish(result, torch.cuda.get_device_name(0), cell.chips)


def finish(result, kind, chips, out=sys.stdout, err=sys.stderr):
    """Print the numbers compared and the result's line, unless a module
    of JAX or of the JAX package has been loaded by now (after the
    per-layer readers and the comparison ran too): then print no result
    and return 1."""
    from portbench.harness import forbidden_modules
    found = forbidden_modules()
    if found:
        print(f"loaded in the process that would print the result: "
              f"{found}; no result", file=err)
        return 1
    checks = result.pop("checks")
    device = {"platform": "gpu", "kind": kind, "count": chips,
              "memory_peak_bytes": result.pop("memory_peak_bytes")}
    for key in ("busy_s", "window_s"):
        if key in result:
            device[key] = result.pop(key)
    line = {"correct": result.pop("correct"), **result, "device": device}
    if "breakdown" in line:
        line["breakdown"] = line.pop("breakdown")
    line["checks"] = checks
    print(f"requests {line['attempted']} attempted, {line['failed']} "
          f"failed", file=err)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(line), file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
