"""Compile-as-a-service demo on the PyTorch/CUDA port: the persistent plan
cache end to end.

    PYTHONPATH=src python examples/serve_compile_torch.py [--cache-dir DIR]
    PYTHONPATH=src python examples/serve_compile_torch.py --device cpu

The twin of ``examples/serve_compile.py`` on ``repro_torch``.  Starts an
in-process :class:`repro_torch.service.CompileService`, then shows the
three request paths:

1. **cold miss** -- full cut-point search (its CUDA kernels on the card),
   plan committed to the cache;
2. **hit** -- the same request decoded from the cache in milliseconds,
   byte-identical to the cold compile (checked via ``encode_plan``),
   with no kernel launched;
3. **warm-started miss** -- the same net on a *new* hw config: the
   nearest cached plan seeds the branch-and-bound incumbent, the result
   is still the oracle-exact argmin.

Point two runs at the same ``--cache-dir`` to see the hits survive a
process restart.  ``--device cpu`` searches with the kernels' plain
versions on the host; without a GPU the default fails the first request.
"""
import argparse
import dataclasses
import tempfile
import time

from repro_torch.cnn import build_cnn
from repro_torch.core.hw import KCU1500
from repro_torch.core.options import CompileOptions
from repro_torch.service import CompileService, encode_plan


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--net", default="resnet50")
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--cache-dir", default=None,
                    help="persistent cache root (default: a temp dir)")
    ap.add_argument("--device", default="cuda",
                    help="where a miss searches: cuda (the default; fails "
                         "without a GPU) or cpu")
    args = ap.parse_args(argv)

    cache_dir = args.cache_dir or tempfile.mkdtemp(prefix="sf-plans-")
    opts = CompileOptions(exhaustive_limit=50_000, device=args.device)
    g = build_cnn(args.net, args.size)

    with CompileService(cache_dir, options=opts) as svc:
        t0 = time.perf_counter()
        cold = svc.compile(g)
        cold_s = time.perf_counter() - t0
        print(f"cold miss:  {cold_s * 1000:8.1f} ms   "
              f"cuts={cold.candidate.cuts}")

        t0 = time.perf_counter()
        ticket = svc.submit(g)
        hit = ticket.result()
        hit_s = time.perf_counter() - t0
        if not ticket.hit or encode_plan(hit) != encode_plan(cold):
            raise AssertionError("the second request was not a hit "
                                 "byte-identical to the cold compile")
        print(f"cache hit:  {hit_s * 1000:8.1f} ms   "
              f"({cold_s / max(hit_s, 1e-9):.0f}x faster, byte-identical)")

        # the same net on a new hw config: a miss, but warm-started from
        # the plan above
        hw2 = dataclasses.replace(KCU1500, name="kcu1500-halfsram",
                                  sram_budget=KCU1500.sram_budget // 2)
        t0 = time.perf_counter()
        ticket = svc.submit(g, hw2)
        warm = ticket.result()
        warm_s = time.perf_counter() - t0
        if ticket.hit:
            raise AssertionError("a new hw config was served from the "
                                 "cache")
        print(f"warm miss:  {warm_s * 1000:8.1f} ms   "
              f"cuts={warm.candidate.cuts} "
              f"(warm_started={ticket.warm_started}, oracle-exact)")

        print(f"stats: {svc.stats}")
        print(f"cache: {len(svc.cache)} records in {cache_dir}")


if __name__ == "__main__":
    main()
