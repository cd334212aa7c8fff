"""D-Adam (Alg. 1) and CD-Adam (Alg. 2) over K stacked workers: topologies
(``topology``), the optimizer math and packed state (``dadam``,
``cdadam``), the compressors (``compression``), the baselines
(``baselines``) and the ``make_optimizer`` facade (``api``). Import the
submodules directly."""
