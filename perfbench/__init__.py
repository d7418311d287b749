"""The benchmark of dprast_torch: cells of `BENCHMARK.json` run on one
card.  Run a cell from the root of a checkout:

    python3 -m perfbench.run --workload proj1024_fit --seed 1 --seconds 10 --trace 0
"""
