"""Missing-value kinds of a split (include/LightGBM/bin.h MissingType).

The value-to-bin mappers of the training data come with the training
slice; prediction needs only the missing-type codes that tree nodes
store in their decision_type bits.
"""


class MissingType:
    NONE = 0
    ZERO = 1
    NAN = 2
