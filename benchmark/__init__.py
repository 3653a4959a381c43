"""The benchmark of corda_tpu_torch: one command runs one cell once.

Everything that decides a number lives here (traffic generation, the plain
reference, the roofline arithmetic, the metric readers), so that a change to
the program cannot move the yardstick. See README.md.
"""
