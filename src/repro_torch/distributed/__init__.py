"""Sharding rules of the dry run (``sharding``): the counterpart of the JAX
package's ``distributed/``."""
