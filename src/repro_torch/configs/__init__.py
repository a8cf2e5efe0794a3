"""Model configurations. This slice ports `dlrm_production`; the LM zoo's
configs and the `--arch` registry come with ROADMAP.md Queue 1 item 15."""
