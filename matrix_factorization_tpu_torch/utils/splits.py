"""Dataset splits for offline and online-update evaluation (PyTorch port).

Counterpart of ``matrix_factorization_tpu/utils/splits.py``, numpy and
pandas only, kept line for line so that one seed gives the same split in
both packages. ``train_update_test_split`` is the reference's 3-way
cold-start protocol (``matrix_factorization/utils.py:8-73``): a fraction
of users is held out of the initial fit, and each held-out user's
ratings are split 50/50 (stratified per user) into an ``update`` set for
``model.update_users`` and a ``test`` set.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import pandas as pd


def train_update_test_split(
    X: pd.DataFrame,
    frac_new_users: float,
    seed: Optional[int] = None,
) -> Tuple[pd.DataFrame, pd.Series, pd.DataFrame, pd.Series, pd.DataFrame, pd.Series]:
    """Split ratings into (train_initial, train_update, test_update).

    Args:
        X: DataFrame with columns ``user_id``, ``item_id``, ``rating``.
        frac_new_users: fraction of users excluded from initial training.
        seed: optional RNG seed for reproducibility.

    Returns ``X_train_initial, y_train_initial, X_train_update,
    y_train_update, X_test_update, y_test_update``.
    """
    rng = np.random.default_rng(seed)
    users = X["user_id"].unique()
    n_new = round(frac_new_users * len(users))
    users_update = set(rng.choice(users, size=n_new, replace=False).tolist())

    is_update_user = X["user_id"].isin(users_update)
    train_initial = X.loc[~is_update_user].sample(
        frac=1, replace=False, random_state=int(rng.integers(0, 2**31 - 1))
    )

    data_update = X.loc[is_update_user]
    # stratified 50/50 per user: shuffle, then the first half of each
    # user's rows (rounded up) goes to the update set
    shuffled = data_update.sample(
        frac=1, replace=False, random_state=int(rng.integers(0, 2**31 - 1))
    )
    pos_in_user = shuffled.groupby("user_id").cumcount()
    counts = shuffled["user_id"].map(shuffled["user_id"].value_counts())
    in_train = pos_in_user < (counts // 2 + (counts % 2))
    train_update = shuffled.loc[in_train]
    test_update = shuffled.loc[~in_train]

    return (
        train_initial[["user_id", "item_id"]],
        train_initial["rating"],
        train_update[["user_id", "item_id"]],
        train_update["rating"],
        test_update[["user_id", "item_id"]],
        test_update["rating"],
    )
