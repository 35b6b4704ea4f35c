"""The port's command-line apps (counterparts of ``pixelnerf_tpu/apps``),
each run as ``python -m pixelnerf_tpu_torch.apps.<name>``: ``train``,
``eval``, ``eval_approx``, ``gen_video``, ``eval_real``, ``preproc`` (the
real-image preprocessor), ``recon`` (mesh extraction), ``calc_metrics``
and ``export_torch``."""
