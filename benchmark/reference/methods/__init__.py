"""One file a method, as the method's reference script trains:

* ``loss(model, P, x, labels, config, gens, prec)``: its loss over a
  training batch;
* ``OPTIMIZER``: the name of its optimizer's file under ``optimizers/``;
* ``work(net, config, batch, dtype)``: (operations, 3x3 conv launches)
  of one step, from the configuration's counts (``harness/work``): the
  forwards with and without a backward that a step runs."""
