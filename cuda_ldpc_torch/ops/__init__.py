"""Tensor ops.  Import the submodules directly; this package imports
nothing itself so that loading one op never builds or loads a kernel."""
