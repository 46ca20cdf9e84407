"""Frozen copies of the port's arithmetic that the benchmark measures with: the
``jax.random`` stream of the 1000-sphere scene (``prng``) and the work and
bound functions of the rooflines (``work``). Each file names the commit it was
copied from; later changes to the port do not reach them."""
