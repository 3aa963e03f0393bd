"""Package paths.

The port ships no data of its own: the default config, the genomes, the
scoring models and the web app's pages are read by path from the JAX
package's ``guidemaker_tpu/data`` folder, which sits beside this package
in the checkout (no file there is imported).
"""
import os

ROOT_DIR = os.path.dirname(os.path.abspath(__file__))
DATA_DIR = os.path.join(os.path.dirname(ROOT_DIR), "guidemaker_tpu", "data")
CONFIG_PATH = os.path.join(DATA_DIR, "config_default.yaml")
WEB_APP = os.path.join(ROOT_DIR, "app.py")
APP_PARAMETER_FILE = os.path.join(DATA_DIR, "parameter_dictionary.md")
APP_PARAMETER_IMG = APP_PARAMETER_FILE  # name kept for reference-API parity
APP_EXPERIMENT_FILE = os.path.join(DATA_DIR, "PooledCRISPRExperiments.md")
#: where the CUDA sources are compiled at first use (listed in .gitignore)
BUILD_DIR = os.path.join(os.path.dirname(ROOT_DIR), "build",
                         "guidemaker_tpu_torch")
