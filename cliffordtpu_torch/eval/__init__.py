"""The evaluation battery (port of ``cliffordtpu/eval``): the model
adapter, prior sampling, class-mean classifier, kNN and the binding
experiments.  Not ported yet: ``plots``, ``tables``, ``fid`` and
``inception``; the plot outputs of the binding experiments wait for
``plots``.

The battery's functions named ``test_*`` are evaluations, as in the JAX
package; import their modules, not the names, where pytest collects."""
