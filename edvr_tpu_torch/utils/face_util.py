"""Face restoration helper: detection, landmark alignment, paste-back, the
counterpart of ``edvr_tpu/utils/face_util.py`` (reference:
basicsr/utils/face_util.py:16-217): dlib CNN detection -> 5-point
landmarks -> similarity warp to the FFHQ template -> (restoration) ->
inverse-affine paste-back with a soft, eroded edge mask.

dlib gives the detection and the landmarks and is optional, as in the JAX
package: without it :meth:`FaceRestorationHelper.init_dlib` raises and the
rest works on landmarks given by the caller. ``cv2`` is imported inside the
functions that use it. The similarity transform is Umeyama's estimator
(the one behind skimage's ``SimilarityTransform``).
"""

from __future__ import annotations

import os

import numpy as np

from edvr_tpu_torch.utils.img_util import imwrite

try:
    import dlib
    HAS_DLIB = True
except ImportError:
    HAS_DLIB = False

# the 5 FFHQ alignment landmarks (two corners of each eye, the nose tip)
# at the template's native 1024x1024
FFHQ_TEMPLATE_1024 = np.array([[686.77227723, 488.62376238],
                               [586.77227723, 493.59405941],
                               [337.91089109, 488.38613861],
                               [437.95049505, 493.51485149],
                               [513.58415842, 678.5049505]])


def umeyama_similarity(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Least-squares similarity transform (rotation, scale, translation)
    mapping ``src`` onto ``dst``, as a 3x3 homogeneous matrix (Umeyama
    1991)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    num, dim = src.shape
    src_mean = src.mean(axis=0)
    dst_mean = dst.mean(axis=0)
    src_demean = src - src_mean
    dst_demean = dst - dst_mean
    A = dst_demean.T @ src_demean / num
    d = np.ones((dim,), np.float64)
    if np.linalg.det(A) < 0:
        d[dim - 1] = -1
    T = np.eye(dim + 1, dtype=np.float64)
    U, S, Vt = np.linalg.svd(A)
    rank = np.linalg.matrix_rank(A)
    if rank == 0:
        return T * np.nan
    if rank == dim - 1:
        if np.linalg.det(U) * np.linalg.det(Vt) > 0:
            T[:dim, :dim] = U @ Vt
        else:
            s = d[dim - 1]
            d[dim - 1] = -1
            T[:dim, :dim] = U @ np.diag(d) @ Vt
            d[dim - 1] = s
    else:
        T[:dim, :dim] = U @ np.diag(d) @ Vt
    scale = 1.0 / src_demean.var(axis=0).sum() * (S @ d)
    T[:dim, dim] = dst_mean - scale * (T[:dim, :dim] @ src_mean.T)
    T[:dim, :dim] *= scale
    return T


def _largest_rect(detections):
    """The dlib detection of the largest area."""
    areas = [(f.rect.right() - f.rect.left()) *
             (f.rect.bottom() - f.rect.top()) for f in detections]
    return detections[int(np.argmax(areas))]


class FaceRestorationHelper:
    """Carries one input image through detect / align / restore / paste
    (reference: face_util.py:16-217)."""

    def __init__(self, upscale_factor, face_size=512):
        self.upscale_factor = upscale_factor
        self.face_size = (face_size, face_size)
        self.face_template = FFHQ_TEMPLATE_1024 / (1024 // face_size)
        self.save_png = True
        self.clean_all()

    def clean_all(self):
        self.all_landmarks_5 = []
        self.all_landmarks_68 = []
        self.affine_matrices = []
        self.inverse_affine_matrices = []
        self.cropped_faces = []
        self.restored_faces = []

    def init_dlib(self, detection_path, landmark5_path, landmark68_path):
        if not HAS_DLIB:
            raise ImportError(
                'dlib is required for face detection/landmarks. Install '
                'dlib to run the face restoration pipeline.')
        self.face_detector = dlib.cnn_face_detection_model_v1(detection_path)
        self.shape_predictor_5 = dlib.shape_predictor(landmark5_path)
        self.shape_predictor_68 = dlib.shape_predictor(landmark68_path)

    def free_dlib_gpu_memory(self):
        del self.face_detector
        del self.shape_predictor_5
        del self.shape_predictor_68

    def read_input_image(self, img_path):
        import cv2
        # kept as (h, w, c) RGB, as dlib wants it
        self.input_img = cv2.cvtColor(cv2.imread(img_path),
                                      cv2.COLOR_BGR2RGB)

    def detect_faces(self, img_path, upsample_num_times=1,
                     only_keep_largest=False):
        """(reference: face_util.py:56-87)"""
        self.read_input_image(img_path)
        found = self.face_detector(self.input_img, upsample_num_times)
        if len(found) == 0:
            print('No face detected. Try to increase upsample_num_times.')
            self.det_faces = found
        elif only_keep_largest:
            self.det_faces = [_largest_rect(found)]
        else:
            self.det_faces = found
        return len(self.det_faces)

    def get_face_landmarks_5(self):
        for face in self.det_faces:
            pts = self.shape_predictor_5(self.input_img, face.rect).parts()
            self.all_landmarks_5.append(np.array([[p.x, p.y] for p in pts]))
        return len(self.all_landmarks_5)

    def get_face_landmarks_68(self):
        """68 landmarks on each aligned crop, detecting again within the
        crop (reference: face_util.py:96-131)."""
        n_found = 0
        for idx, face in enumerate(self.cropped_faces):
            found = self.face_detector(face, 1)
            if len(found) == 0:
                print(f'Cannot find faces in cropped image with index '
                      f'{idx}.')
                self.all_landmarks_68.append(None)
                continue
            rect = (_largest_rect(found) if len(found) > 1
                    else found[0]).rect
            pts = self.shape_predictor_68(face, rect).parts()
            self.all_landmarks_68.append(np.array([[p.x, p.y]
                                                   for p in pts]))
            n_found += 1
        return n_found

    def warp_crop_faces(self, save_cropped_path=None,
                        save_inverse_affine_path=None):
        """Similarity-warp each face's 5 landmarks onto the template and
        keep the inverse transform, into the upscaled image, for the paste
        (reference: face_util.py:133-169)."""
        import cv2
        for idx, landmark in enumerate(self.all_landmarks_5):
            to_template = umeyama_similarity(landmark,
                                             self.face_template)[:2]
            self.affine_matrices.append(to_template)
            crop = cv2.warpAffine(self.input_img, to_template,
                                  self.face_size)
            self.cropped_faces.append(crop)
            if save_cropped_path is not None:
                stem, ext = os.path.splitext(save_cropped_path)
                ext = '.png' if self.save_png else ext
                imwrite(cv2.cvtColor(crop, cv2.COLOR_RGB2BGR),
                        f'{stem}_{idx:02d}{ext}')
            from_template = umeyama_similarity(
                self.face_template, landmark * self.upscale_factor)[:2]
            self.inverse_affine_matrices.append(from_template)
            if save_inverse_affine_path is not None:
                stem, _ = os.path.splitext(save_inverse_affine_path)
                np.save(f'{stem}_{idx:02d}.npy', from_template)

    def add_restored_face(self, face):
        self.restored_faces.append(face)

    def _soft_mask(self, inverse_affine, out_wh):
        """The warped face mask, its border eroded, and its Gaussian-
        feathered centre, so the paste blends into the upscaled background
        (reference: face_util.py:186-202)."""
        import cv2
        mask = cv2.warpAffine(np.ones((*self.face_size, 3), np.float32),
                              inverse_affine, out_wh)
        border = 2 * self.upscale_factor
        eroded = cv2.erode(mask, np.ones((border, border), np.uint8))
        face_area = np.sum(eroded) // 3
        edge = int(face_area**0.5) // 20
        center = cv2.erode(eroded, np.ones((2 * edge, 2 * edge), np.uint8))
        return eroded, cv2.GaussianBlur(center, (2 * edge + 1, 2 * edge + 1),
                                        0)

    def paste_faces_to_input_image(self, save_path=None):
        """Inverse-affine paste with soft edges onto the upscaled input
        (reference: face_util.py:173-210). Returns the BGR result (float,
        as blended) and writes it as uint8 to ``save_path`` when given."""
        import cv2
        canvas = cv2.cvtColor(self.input_img, cv2.COLOR_RGB2BGR)
        h, w = canvas.shape[:2]
        out_wh = (w * self.upscale_factor, h * self.upscale_factor)
        canvas = cv2.resize(canvas, out_wh)
        if len(self.restored_faces) != len(self.inverse_affine_matrices):
            raise ValueError(f'{len(self.restored_faces)} restored faces '
                             f'for {len(self.inverse_affine_matrices)} '
                             'aligned ones')
        for face, inverse_affine in zip(self.restored_faces,
                                        self.inverse_affine_matrices):
            warped = cv2.warpAffine(face, inverse_affine, out_wh)
            eroded, soft = self._soft_mask(inverse_affine, out_wh)
            canvas = soft * (eroded * warped) + (1 - soft) * canvas
        if save_path is not None:
            if self.save_png:
                save_path = save_path.replace('.jpg', '.png').replace(
                    '.jpeg', '.png')
            imwrite(canvas.astype(np.uint8), save_path)
        return canvas
