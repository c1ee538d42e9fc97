"""Entry points of the port: the serving and training CLIs (``serve``,
``train``), and the launch layer: meshes (``mesh``), cells (``steps``),
their cost analysis (``cost_analysis``) and the dry run (``dryrun``)."""
