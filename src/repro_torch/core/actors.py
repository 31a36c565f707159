"""Actor support shared by the policy engines.

Holds only ``STEP_MOD`` for now: the feed-forward and batched actors of
``repro/core/actors.py`` come with the DQN slice.
"""

# Batch and step counters wrap here, so a seed derived from them stays in
# range however long a run lasts.
STEP_MOD = 2 ** 31
