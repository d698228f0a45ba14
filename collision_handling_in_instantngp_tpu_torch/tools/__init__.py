"""Tools of the port: the measurement tools (``sweep_probe``, ``mxu_probe``,
``profile_epoch``, ``roofline``, ``time_kernels``, the phase splitters) and
the grid study's drivers (``run_grid_demo``, ``grid_leaderboard``,
``rerank_top``, ``seed_panel``, ``usage_stats``, ``run_macaws``, and
``run_cold``). Each runs on the card unless ``--device cpu`` (or
``--device=cpu``) is given; ``grid_leaderboard`` reads JSON only."""
