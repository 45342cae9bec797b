"""Dataset generators of the port (numpy only): copies of the JAX
package's ``datagen`` modules that the port's experiments call at run
time, kept operation for operation so the same arguments give the same
bits."""
