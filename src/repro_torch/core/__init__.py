"""D-Adam (Alg. 1) over K stacked workers: topologies (``topology``), the
optimizer math and packed state (``dadam``) and the ``make_optimizer``
facade (``api``). Import the submodules directly."""
