"""The port's evaluation entry points, the counterparts of the JAX
package's ``tools/quality_probe.py``, ``tools/evidence_eval.py`` and
``tools/flagship_ckpt_dryrun.py``, and its own copy of the procedural
images of ``tools/make_synth_dataset.py`` (``synth``)."""
