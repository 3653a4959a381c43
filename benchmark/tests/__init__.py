"""CPU tests of the benchmark: its registry, reference, roofline arithmetic,
import isolation, a tiny rehearsal of each driver, and the controls and
planted faults that `correct` must catch."""
