"""Launch tooling of the port; counterpart of ``repro.launch``: the mesh
description, the dry run over every (arch x shape) cell, perf iteration
on one cell and the roofline table. Importing these modules sets no
environment variable."""
