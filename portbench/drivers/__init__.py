"""The entry drivers: one module per path of the program that a cell
runs (``setup``, ``window``, ``release``, ``check``)."""
