"""The benchmark's own code: spec lookup, inputs made from the seed, the
work counts and peaks, the trace reduction, the comparisons and the
drivers of each kind of cell. Nothing here imports JAX or the JAX
package; the drivers import the port (``wsl4mis_torch``) and nothing
else of the repository."""
