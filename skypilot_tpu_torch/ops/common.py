"""Constants shared by the port's attention code.

``NEG_INF`` is the finite mask value of ``skypilot_tpu/ops/pallas/
common.py`` and ``ops/attention.py``. It must stay finite: a fully
masked query row (a padded verify position, or an inactive slot whose
``n_valid`` is 1 in ``paged_verify_step``) then gives
``exp(NEG_INF - NEG_INF) == 1``, i.e. uniform weights, where ``-inf``
would give NaN.
"""
NEG_INF = -1e30
