"""Architecture files: one per architecture the benchmark serves.

A configuration file names its architecture file under ``reference``
(``bench/manifest.py``); the harness loads it by path and reads nothing
else of the architecture.  It imports nothing of the program (the
yardstick's ``bench.counts`` it may), and exports:

* ``Reference(model, params, quant=None)``, whose ``.logits(seqs,
  positions)`` gives, for each token sequence, its float32 logits at those
  positions: the plain reference that decides ``correct``
  (``bench.check``).  ``model`` is the configuration's ``"model"``
  section, ``params`` the weights the benchmark drew from the seed.
  ``quant="fp8"`` is the control: the same pass in float8
  (``bench/control.py``);
* the yardstick's counts for the architecture, each summed over all of
  the model's layers (``model`` as above):

  - ``prefill_flops(model, S)``: operations of a prompt of ``S`` tokens;
  - ``decode_flops(model, context)``: operations of one new token after
    ``context`` stored tokens;
  - ``paged_least_s(model, lengths, max_pages)``: the least seconds the
    card could take for one decode round's paged attention, rows holding
    ``lengths`` tokens before the step, over every layer that kernel
    serves;
  - ``flash_least_s(model, S)``: the same for one prompt's flash
    attention over ``S`` tokens.

The per-layer readers (``bench/metrics/``) take these through
``bench.record.architecture``.  ``model.py`` is the dense decoders'.
"""
