"""Run-time analysis of the port's simulator: the sim sanitizer
(``sanitizer``), the port's copy of the JAX package's.  The JAX package's
static analysis (simlint, HLO parsing, the roofline) is not copied here."""
