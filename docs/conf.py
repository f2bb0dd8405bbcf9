# Sphinx configuration for the lcgp_tpu documentation.
#
# Counterpart of the reference's docs build (reference docs/conf.py:
# sphinx + myst-nb with executed notebooks).  The illustration notebook in
# this tree is committed *with outputs* and rendered as-is
# (nb_execution_mode = "off") so the docs build needs no accelerator; flip
# to "cache" to re-execute during the build.
import os
import sys

sys.path.insert(0, os.path.abspath(".."))

project = "lcgp_tpu"
author = "lcgp_tpu developers"
copyright = "2026, lcgp_tpu developers"

extensions = [
    "myst_nb",
    "sphinx.ext.autodoc",
    "sphinx.ext.napoleon",
    "sphinx.ext.viewcode",
    "sphinx.ext.mathjax",
]

# myst-nb: render the committed notebook outputs, don't re-execute
nb_execution_mode = "off"
nb_execution_timeout = 300

myst_enable_extensions = ["dollarmath", "colon_fence"]

source_suffix = {
    ".rst": "restructuredtext",
    ".md": "myst-nb",
    ".ipynb": "myst-nb",
}

exclude_patterns = ["_build", "**.ipynb_checkpoints"]

html_theme = "alabaster"
html_title = "lcgp_tpu — Latent Component GP in JAX"

autodoc_member_order = "bysource"
autodoc_typehints = "description"
