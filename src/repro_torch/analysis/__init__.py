"""Run-time analysis of the port: the sim sanitizer (``sanitizer``), the
port's copy of the JAX package's, and the dry run's accounting: the
collectives a traced step issues (``collectives``, in place of the JAX
package's HLO parser) and the three-term roofline (``roofline``).  The JAX
package's static analysis (simlint) is not copied here: it lints the port
as it is."""
