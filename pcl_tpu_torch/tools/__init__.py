"""Command-line tools over pcl_tpu_torch, with the arguments and printed
lines of their counterparts under ``pcl_tpu/tools``. Each takes ``--device``
(default ``cuda``; ``cpu`` runs the same code on the host): without a card and
without ``--device cpu`` a tool fails with the error the first constructor
raises; none moves to the CPU by itself."""
