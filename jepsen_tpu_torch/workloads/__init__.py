"""Workloads: the partial tests (a generator and a checker) the port
carries. ``workloads.cycle`` has elle's list-append and rw-register
checkers; the reference's database-driving workloads are not ported."""
