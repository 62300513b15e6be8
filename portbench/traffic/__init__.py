"""Traffic generators, one module per kind; a mix is a data file
(``<traffic>.json``) that names its kind and gives its parameters."""
