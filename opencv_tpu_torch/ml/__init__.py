"""ml (modules/ml) on the card: the port of ``opencv_tpu.ml``.  KNearest,
NormalBayes, LogisticRegression, ANN_MLP and the SVM's kernels compute on a
model's device ("cuda" unless made with ``device="cpu"``); SVMSGD, the
trees and EM are the JAX package's numpy host code.  ``carry`` turns a
trained JAX model's arrays into a port model."""

from .classic import (  # noqa: F401
    KNearest, KNearest_create,
    NormalBayesClassifier, NormalBayesClassifier_create,
    LogisticRegression, LogisticRegression_create,
    ROW_SAMPLE, COL_SAMPLE,
)
from .svm import SVM, SVM_create  # noqa: F401
from .svmsgd import SVMSGD  # noqa: F401


def SVMSGD_create():
    return SVMSGD.create()


from .trees import (  # noqa: F401,E402
    DTrees, DTrees_create, RTrees, RTrees_create, Boost, Boost_create,
)
from .nets import ANN_MLP, ANN_MLP_create, EM, EM_create  # noqa: F401,E402
from .carry import from_reference  # noqa: F401,E402
