"""Quickstart on the PyTorch/CUDA port: compile a CNN with ShortcutFusion
and inspect the plan.

    PYTHONPATH=src python examples/quickstart_torch.py [--net efficientnet-b1]
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The twin of ``examples/quickstart.py`` on ``repro_torch``: the paper's
whole pipeline (Fig. 4) -- parse/group -> reuse-aware allocation ->
cut-point optimization -> instruction stream -> functional simulation
(numerical check against the port's plain torch reference,
``cnn/torch_ref.py::run_graph``, and the DRAM traffic audit).  The cut
search runs its CUDA kernels on the card (``CompileOptions()``'s
``pipeline`` engine); ``--device cpu`` runs their plain versions on the
host instead.  Without a GPU the default raises.
"""
import argparse

import numpy as np

from repro_torch.cnn import build_cnn
from repro_torch.cnn.torch_ref import init_params, load_params, run_graph
from repro_torch.core.compiler import compile_graph
from repro_torch.core.options import CompileOptions
from repro_torch.core.simulator import simulate

MB = 1 << 20


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--net", default="efficientnet-b1")
    ap.add_argument("--size", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the search and the numerics run: cuda "
                         "(the default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    options = CompileOptions(device=args.device)

    g = build_cnn(args.net, args.size or None)
    print(f"graph: {len(g)} nodes, {g.total_macs() / 1e9:.2f} GMACs, "
          f"{g.total_weight_bytes() / MB:.1f} MB weights")

    plan = compile_graph(g, options=options)
    print(plan.summary())
    print(f"cut-point search evaluated "
          f"{plan.search.evaluated if plan.search else 0} candidates over "
          f"{len(plan.search.runs) if plan.search else 0} monotone runs")

    modes = [i.mode for i in plan.instructions]
    print(f"policy: {modes.count(0)} row-reuse groups, "
          f"{modes.count(1)} frame-reuse groups")
    print(f"buffers {{0,1,2}}: "
          f"{[round(b / MB, 3) for b in plan.alloc.buff]} MB, "
          f"side {plan.alloc.side_buff / 1024:.1f} KB")

    # dry traffic audit: instruction-stream simulation == analytic model
    _, counters = simulate(plan.grouped, plan.alloc, plan.instructions,
                           execute=False)
    if counters.fm_total != plan.dram.fm_bytes:
        raise AssertionError(f"simulator fm {counters.fm_total} != the "
                             f"model's {plan.dram.fm_bytes}")
    print(f"simulator audit: fm={counters.fm_total / MB:.2f} MB "
          f"(matches eq.8), weights={counters.weight_reads / MB:.1f} MB "
          f"(read exactly once)")

    # numerical check on a reduced-size twin of the same family
    small = build_cnn(args.net, 64)
    splan = compile_graph(small, options=options)
    params = load_params(init_params(small), args.device)
    x = np.random.default_rng(0).standard_normal(
        (1, 64, 64, 3), dtype=np.float32)
    out, _ = simulate(splan.grouped, splan.alloc, splan.instructions,
                      params, x, device=args.device)
    ref = run_graph(small, params, x, device=args.device)[len(small.nodes)
                                                          - 1]
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    print("numerical check vs torch reference: OK")


if __name__ == "__main__":
    main()
