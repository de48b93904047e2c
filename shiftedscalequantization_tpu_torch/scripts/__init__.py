"""The accuracy scripts, each run as ``python -m
shiftedscalequantization_tpu_torch.scripts.<name>``: ``run_accuracy``,
``advantage_demo``, ``imagenet_drill`` and ``harm_accuracy``. Importing one
does nothing; its ``main(argv)`` runs it."""
