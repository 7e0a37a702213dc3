"""Framework integration plugins of the port: ``pytorch`` (iterators),
``proxy`` (the ``DataLoader`` proxy), ``triton`` (model repositories),
``tf``, ``paddle`` and ``numba``."""
