"""CPU tests of the benchmark; those that need a card skip without one."""
