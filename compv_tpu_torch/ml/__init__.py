"""ML layer (mirror of compv_tpu.ml): SVM and KNN / ANN search."""
from compv_tpu_torch.ml.svm import (  # noqa: F401
    MultiClassSvm, ProbSvmModel, SvmConfig, SvmModel, platt_fit,
    platt_probability, svm_cross_validate, svm_decision, svm_load_json,
    svm_load_libsvm, svm_predict, svm_predict_multiclass, svm_predict_proba,
    svm_save_json, svm_save_libsvm, svm_train, svm_train_multiclass,
    svm_train_probabilistic, svr_predict, svr_train,
)
from compv_tpu_torch.ml.knn import (  # noqa: F401
    AnnConfig, AnnIndex, KnnIndex, ann_build, ann_search, knn_build,
    knn_load_json, knn_save_json, knn_search,
)
