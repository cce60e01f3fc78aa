"""Command-line tools built on the port: inverse rendering (``fit_scene``,
``fit_volume``), the OpenVDB codec (``vdb``), the density-grid converter
(``grid_convert``) and the majorant analysis (``majorant_stats``)."""
